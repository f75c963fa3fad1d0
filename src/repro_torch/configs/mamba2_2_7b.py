"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,            # d_inner = 5120, 80 SSD heads of dim 64
    ssm_chunk=128,
    dtype=torch.bfloat16,
    source="arXiv:2405.21060",
)
