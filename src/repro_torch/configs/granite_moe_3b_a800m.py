"""granite-moe-3b-a800m [moe] — 40 experts top-8, narrow experts.
[hf:ibm-granite/granite-3.0-1b-a400m-base family card, scaled per assignment]"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                # per-expert width (narrow-expert regime)
    vocab_size=49_155,
    num_experts=40,
    experts_per_token=8,
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
