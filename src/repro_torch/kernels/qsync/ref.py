"""Plain PyTorch version of the fused qsync kernel.

The arithmetic of ``repro.kernels.qsync.ref.qsync_flat_ref`` written in
torch: per-agent block quantize and dequantize of the uplink, the
weighted reduce over the agent grid, the downlink re-quantize.
"""
from __future__ import annotations

import torch

F16_MAX = 65504.0  # largest finite float16, the clamp of the wire scale


def _wire_scale(amax: torch.Tensor, qmax: int):
    """The f16 scale that ships, and the f32 value both ends divide by.
    Clamped to f16's finite range: an overflowing block clips hard (error
    feedback absorbs it) instead of shipping inf and decoding 0 * inf =
    NaN.  A port of ``repro.kernels.qpack.kernel._wire_scale``.

    ``qmax`` is divided by as a tensor on ``amax``'s device: on the card
    PyTorch divides by a Python number as a multiply by its rounded
    reciprocal, which is not the IEEE quotient the kernel and the
    reference take."""
    q = torch.full((), qmax, dtype=torch.float32, device=amax.device)
    s_wire = torch.clamp(amax / q, max=F16_MAX).to(torch.float16)
    s_dec = torch.where(s_wire > 0, s_wire.float(),
                        torch.ones((), dtype=torch.float32, device=amax.device))
    return s_wire, s_dec


def roundtrip_blocks_ref(x: torch.Tensor, *, qmax: int, block: int) -> torch.Tensor:
    """x (R, N), N a multiple of ``block``: the block-scaled quantize then
    dequantize of every row, codes ``clip(round_half_even(x / s), ±qmax)``."""
    R, N = x.shape
    tiles = x.float().reshape(R, N // block, block)
    amax = tiles.abs().amax(dim=-1, keepdim=True)
    _, s_dec = _wire_scale(amax, qmax)
    q = torch.clamp(torch.round(tiles / s_dec), -qmax, qmax)
    return (q * s_dec).reshape(R, N)


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
