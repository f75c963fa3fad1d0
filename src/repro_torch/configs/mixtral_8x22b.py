"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,              # per-expert FFN width
    vocab_size=32_768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,     # SWA on every layer
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    source="arXiv:2401.04088",
)
