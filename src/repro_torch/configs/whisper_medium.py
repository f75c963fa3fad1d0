"""whisper-medium [audio] — enc-dec; mel/conv frontend STUBBED (input_specs
feeds precomputed frame embeddings).  [arXiv:2212.04356]

Adaptation note: whisper's learned absolute positions are replaced with RoPE
(recorded in DESIGN.md); LayerNorm retained.
"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,           # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    encoder_layers=24,
    encoder_seq=1500,        # 30 s of audio after the (stubbed) conv frontend
    cross_attention=True,
    frontend_stub=True,
    norm="layernorm",
    dtype=torch.bfloat16,
    source="arXiv:2212.04356",
)
