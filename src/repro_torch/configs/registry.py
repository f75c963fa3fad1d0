"""Architecture registry (a port of ``repro.configs.registry``).

The port has seven of the reference's ten architectures: the dense
(gemma3-4b, qwen3-8b, phi4-mini-3.8b, glm4-9b), MoE (mixtral-8x22b,
granite-moe-3b-a800m) and SSM (mamba2-2.7b) families.  Asking for one of
the other three raises a ``KeyError`` that names the ROADMAP slice
bringing it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

# the reference's other archs, and the ROADMAP slice (queue 1) that ports them
_LATER = {
    "whisper-medium": "slice 5 (audio)",
    "zamba2-7b": "slice 5 (hybrid)",
    "chameleon-34b": "slice 5 (vlm)",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _LATER:
        raise KeyError(f"arch {name!r} is not ported yet: ROADMAP queue 1, "
                       f"{_LATER[name]}; ported: {list_archs()}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
