"""qwen3-8b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    source="hf:Qwen/Qwen3-8B",
)
