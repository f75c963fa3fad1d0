"""Carry weights and state between the JAX reference and the port.

Both packages key their parameter dicts alike and keep the same layouts
(Dense ``(in, out)``, conv HWIO, transpose conv HWOI), so the conversion
is leaf by leaf, with no transposes.  The JAX side is handed over as
numpy arrays (``jax.device_get`` of a pytree), so this module needs no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def from_jax_params(tree, device="cuda"):
    """A tree of numpy arrays (dicts, lists, tuples) -> the same tree of
    tensors on ``device``, dtypes kept.  The card by default, which raises
    without a GPU; pass ``device="cpu"`` to convert onto the CPU."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(dev),
                    tree)


def to_jax_params(tree):
    """The inverse: a tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
