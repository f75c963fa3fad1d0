"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

81 blocks; every 6th block applies the SHARED transformer block (single
parameter set reused at 13 positions, remainder 3 blocks are Mamba2),
matching Zamba2's shared-attention design in a scan-friendly grouping.
"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    hybrid_period=6,         # 1 shared-attn + 5 mamba per group
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    source="arXiv:2411.15242",
)
