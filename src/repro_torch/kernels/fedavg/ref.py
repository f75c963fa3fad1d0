"""Plain PyTorch version of the fedavg kernel."""
from __future__ import annotations

import torch


def fedavg_flat_ref(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` shaped like the agent grid ((B,) or (P, A)), ``stacked``
    (B, N).  Products and sum in float32, the sum taken over the grid's own
    axes like ``repro.dist.collectives.weighted_mean``; the result is cast
    back to the input dtype."""
    grid = tuple(weights.shape)
    prod = weights.float().reshape(-1, 1) * stacked.float()
    acc = prod.reshape(grid + (-1,)).sum(dim=tuple(range(len(grid))))
    return acc.to(stacked.dtype)
