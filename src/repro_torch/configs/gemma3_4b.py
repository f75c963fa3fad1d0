"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family card, scaled per assignment]"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,            # gemma3 fixes head_dim=256 independent of d_model
    d_ff=10240,
    vocab_size=262_144,
    sliding_window=1024,     # local layers
    local_global_ratio=5,    # 5 local : 1 global
    qk_norm=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    source="hf:google/gemma-3-1b-pt",
)
