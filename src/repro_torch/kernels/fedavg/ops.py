"""The pytree wrapper of the fedavg kernel (a port of
``repro.kernels.fedavg.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg.kernel import fedavg_flat
from repro_torch.kernels.fedavg.ref import agent_dims
from repro_torch.tree import tree_map


def fedavg_tree(weights: torch.Tensor, stacked_tree):
    """Weighted average over the leading agent axis of every leaf of
    ``stacked_tree``: leaves (B, ...) or (P, A, ...), as many leading dims
    consumed as make up the B = ``weights.numel()`` agents.  One
    ``fedavg_flat`` launch per leaf (float32 products and sum); each leaf's
    dtype is kept.  Returns the averaged tree, agent axis removed."""
    w = weights.reshape(-1).float()
    B = w.shape[0]

    def avg(x):
        nd = agent_dims(x.shape, B, weights.dim())
        out = fedavg_flat(w, x.reshape(B, -1).contiguous())
        return out.reshape(x.shape[nd:]).to(x.dtype)

    return tree_map(avg, stacked_tree)
