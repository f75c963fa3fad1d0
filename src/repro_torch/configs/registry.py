"""Architecture registry (a port of ``repro.configs.registry``).

The port has the two architectures of the backbone slice; asking for
another arch the reference registers raises a ``KeyError`` that names the
ROADMAP slice bringing it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

# the reference's other archs, and the ROADMAP slice (queue 1) that ports them
_LATER = {
    "mixtral-8x22b": "slice 5 (MoE)",
    "qwen3-8b": "slice 5 (serving archs)",
    "phi4-mini-3.8b": "slice 5 (serving archs)",
    "whisper-medium": "slice 5 (audio)",
    "glm4-9b": "slice 5 (serving archs)",
    "zamba2-7b": "slice 5 (hybrid)",
    "granite-moe-3b-a800m": "slice 5 (MoE)",
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
