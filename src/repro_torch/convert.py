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
    without a GPU; pass ``device="cpu"`` to convert onto the CPU.  A
    bfloat16 leaf (numpy's ``ml_dtypes`` type, which torch cannot wrap)
    goes through float32, exactly."""
    dev = resolve_device(device)

    def leaf(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return tree_map(leaf, tree)


def backbone_params_from_jax(tree, device="cuda"):
    """The reference Backbone's params (``jax.device_get`` of
    ``Backbone.init``: nested dicts of numpy arrays, stacked layers with
    their leading ``(L,)`` or ``(G, r)`` dims) -> the port's Backbone params
    on ``device``.  Keys, shapes and layouts are the same in both packages,
    so this is ``from_jax_params``, leaf by leaf."""
    return from_jax_params(tree, device=device)


def to_jax_params(tree):
    """The inverse: a tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
