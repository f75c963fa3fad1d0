"""chameleon-34b [vlm] — early fusion; VQ image tokens share the text
vocabulary, so the backbone consumes one interleaved token stream.  The
VQ-VAE image tokenizer is the STUBBED frontend (input_specs provides token
ids).  [arXiv:2405.09818]"""
import torch

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    qk_norm=True,            # chameleon uses qk-norm for stability
    frontend_stub=True,
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    source="arXiv:2405.09818",
)
