"""Plain PyTorch versions of the fedavg kernels."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def fedavg_flat_ref(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` shaped like the agent grid ((B,) or (P, A)), ``stacked``
    (B, N).  Products in float32, each rounded, summed from +0 in agent
    order, as the kernel sums them and as the reference's
    ``weighted_mean`` sums them run op by op; the result is cast back to
    the input dtype."""
    prod = weights.float().reshape(-1, 1) * stacked.float()
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32, device=stacked.device)
    for b in range(prod.shape[0]):
        acc = acc + prod[b]
    return acc.to(stacked.dtype)


def fedavg_wire_ref(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``repro.dist.collectives.weighted_mean`` in the type T of
    ``stacked`` (B, N), bfloat16 or float16: each weight rounded to T, each
    product rounded to T (the float32 product of two T values is exact, so
    this is the correctly rounded product), the products summed in float32
    in agent order, the sum rounded to T."""
    T = stacked.dtype
    w = weights.reshape(-1).to(T).float()
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32, device=stacked.device)
    for b in range(stacked.shape[0]):
        acc = acc + (w[b] * stacked[b].float()).to(T).float()
    return acc.to(T)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as ``__fmaf_rn``.  The product of two
    float32 values is exact in float64; the sum with c is taken in float64
    with its rounding error (two-sum), and rounded to odd when inexact, so
    the final rounding to float32 (29 bits fewer) is not a double
    rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(odd, torch.nextafter(s, toward), s).float()


def intra_pod_weights(weights: torch.Tensor) -> torch.Tensor:
    """w / sum_a w per pod, the row summed in agent order, as
    ``repro.dist.collectives.average_intra_pod`` computes it."""
    s = weights[:, 0]
    for a in range(1, weights.shape[1]):
        s = s + weights[:, a]
    return weights / s[:, None]


def fedavg_pod_ref(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` (P, A), ``stacked`` (P, A, N) float32 -> (P, N): per pod
    a fused multiply-add chain over the agents in order, from +0."""
    w = intra_pod_weights(weights.float())
    acc = torch.zeros((stacked.shape[0], stacked.shape[2]), dtype=torch.float32,
                      device=stacked.device)
    for a in range(stacked.shape[1]):
        acc = fma_f32(w[:, a:a + 1].expand_as(acc), stacked[:, a], acc)
    return acc


def fedavg_pod_low_ref(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` (P, A), ``stacked`` (P, A, N) bfloat16 or float16 -> (P,
    N) in that type T: the reference's einsum in T, as XLA computes it.
    Each pod's weights (``intra_pod_weights``) rounded to T, both operands
    widened to float32, the fused multiply-add chain over the agents in
    order from +0, the sum rounded to T once."""
    T = stacked.dtype
    w = intra_pod_weights(weights.float()).to(T).float()
    acc = torch.zeros((stacked.shape[0], stacked.shape[2]), dtype=torch.float32,
                      device=stacked.device)
    for a in range(stacked.shape[1]):
        acc = fma_f32(w[:, a:a + 1].expand_as(acc), stacked[:, a].float(), acc)
    return acc.to(T)


def agent_dims(shape, B: int, weight_dims: int = 1) -> int:
    """How many leading dims of ``shape`` make up the B agents: 1 for
    (B, ...), 2 for (P, A, ...).  One agent is ambiguous (any run of
    leading 1s makes it up): then the weights' own dims, ``weight_dims``
    (1 for (1,) weights, 2 for (1, 1))."""
    if B == 1:
        if tuple(shape[:weight_dims]) != (1,) * weight_dims:
            raise ValueError(f"leaf shape {tuple(shape)} incompatible with 1 agent")
        return weight_dims
    prod, nd = 1, 0
    while prod < B:
        prod *= shape[nd]
        nd += 1
    if prod != B:
        raise ValueError(f"leaf shape {tuple(shape)} incompatible with {B} agents")
    return nd


def fedavg_tree_ref(weights, stacked_tree):
    """Weighted average over the leading agent axis, B or (P, A), of every
    leaf (float32 products and sum), each leaf's dtype kept."""
    w = weights.reshape(-1).float()
    B = w.shape[0]

    def avg(x):
        nd = agent_dims(x.shape, B, weights.dim())
        return fedavg_flat_ref(w, x.reshape(B, -1)).reshape(x.shape[nd:]).to(x.dtype)

    return tree_map(avg, stacked_tree)
