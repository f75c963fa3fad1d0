"""Plain PyTorch versions of the two qsync kernels.

``qsync_flat_ref``: the arithmetic of ``repro.kernels.qsync.ref.qsync_flat_ref``
written in torch: per-agent block quantize and dequantize of the uplink,
the weighted reduce over the agent grid, the downlink re-quantize.
``adam_sync_flat_ref``: ``optim.Adam.update``'s step followed by the block
quantize of the new params (``repro.kernels.qsync.ref.adam_sync_flat_ref``).
The quantizer's arithmetic is qpack's (``kernels/qpack/ref.py``), as in
the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qpack.ref import _wire_scale  # noqa: F401  (re-exported)
from repro_torch.kernels.qpack.ref import quant_blocks_ref, roundtrip_blocks_ref


def qsync_flat_ref(weights, stacked, ef=None, ef_down=None, *, qmax: int,
                   block: int):
    """``weights`` shaped like the agent grid ((P, A) or (B,)), ``stacked``
    (B, N) float32 with N a multiple of ``block``, optional residuals ``ef``
    (B, N) and ``ef_down`` (N,).  Returns ``(synced (N,), new_ef | None,
    new_ef_down | None)``; the residual outputs mirror the inputs.  The
    reduce adds the rounded products one agent at a time, in agent order,
    as the kernel does: a library sum groups its terms in another order
    (on the card, differently again), which moves the last bit of ``m`` and
    with it ``new_ef_down`` and, at a rounding tie, a code of ``synced``."""
    w = weights.float().reshape(-1, 1)
    y = stacked + ef if ef is not None else stacked
    dq = roundtrip_blocks_ref(y, qmax=qmax, block=block)   # uplink wire image
    prod = w * dq
    m = prod[0]
    for b in range(1, prod.shape[0]):
        m = m + prod[b]
    m = m[None]
    yd = m + ef_down.reshape(1, -1) if ef_down is not None else m
    dqd = roundtrip_blocks_ref(yd, qmax=qmax, block=block)  # downlink image
    return (dqd[0],
            y - dq if ef is not None else None,
            yd[0] - dqd[0] if ef_down is not None else None)


def adam_sync_flat_ref(hyper, params, grads, mu, nu, *, b1: float, b2: float,
                       eps: float, qmax: int, block: int):
    """``hyper`` the (1, 3) float32 row [lr, bc1, bc2] on the params'
    device, ``params``, ``grads``, ``mu``, ``nu`` (B, N) float32 with N a
    multiple of ``block``.  Returns ``(new_params, new_mu, new_nu, codes
    int8 (B, N), scales f16 (B, N // block))``.

    The operations and their order are ``optim.Adam.update``'s, each
    rounded on its own as PyTorch runs them eagerly (no fused
    multiply-add): ``b1 * mu + (1 - b1) * g``, ``b2 * nu + (1 - b2) * g^2``,
    ``p - (lr * (mu' / bc1)) / (sqrt(nu' / bc2) + eps)``.  The bias
    corrections are divided by as 0-d tensors on the params' device: on the
    card PyTorch divides by a Python number as a multiply by its rounded
    reciprocal.  The reference jits the same function on XLA:CPU, which
    contracts the moment updates into fused multiply-adds, so it agrees
    with this one to a few ulps, not bit for bit."""
    lr, bc1, bc2 = hyper[0, 0], hyper[0, 1], hyper[0, 2]
    new_mu = b1 * mu + (1 - b1) * grads
    new_nu = b2 * nu + (1 - b2) * torch.square(grads)
    new_params = params - lr * (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + eps)
    q, s = quant_blocks_ref(new_params, qmax=qmax, block=block)
    return new_params, new_mu, new_nu, q, s
