"""Architecture registry (a port of ``repro.configs.registry``): all ten
of the reference's architectures, the dense (gemma3-4b, qwen3-8b,
phi4-mini-3.8b, glm4-9b), MoE (mixtral-8x22b, granite-moe-3b-a800m), SSM
(mamba2-2.7b), hybrid (zamba2-7b), audio (whisper-medium) and vlm
(chameleon-34b) families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def pair_supported(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for the (arch x shape) matrix.

    long_500k needs sub-quadratic attention: SSM/hybrid run natively;
    dense/MoE run only with a sliding-window variant; whisper's enc-dec
    decoder is bounded by its 30 s audio context.
    """
    cfg = get_config(arch)
    if shape != "long_500k":
        return True, ""
    if cfg.family == "audio":
        return False, "enc-dec audio decoder: 500k-token cache out of family (30 s source)"
    if not cfg.supports_long_decode:
        return False, "pure full attention; no sliding-window/block-sparse variant"
    return True, ""
