"""Plain PyTorch version of the fused qsync kernel.

The arithmetic of ``repro.kernels.qsync.ref.qsync_flat_ref`` written in
torch: per-agent block quantize and dequantize of the uplink, the
weighted reduce over the agent grid, the downlink re-quantize.  The
quantizer's arithmetic is qpack's (``kernels/qpack/ref.py``), as in the
reference.
"""
from __future__ import annotations

from repro_torch.kernels.qpack.ref import _wire_scale  # noqa: F401  (re-exported)
from repro_torch.kernels.qpack.ref import roundtrip_blocks_ref


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
