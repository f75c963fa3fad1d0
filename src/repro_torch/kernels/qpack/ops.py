"""Public entry points of the codec's wire transform (a port of
``repro.kernels.qpack.ops``).

``quantize_blocks`` / ``dequantize_blocks`` / ``roundtrip_blocks`` flatten
any batch of flat streams to (R, N), pad N up to the block multiple, and
run the kernels of ``kernel.py``: the tensor's device decides between the
CUDA kernel and its plain version.

Wire format (what ``repro_torch.comm`` bills): ``ceil(N * bits / 8)``
payload bytes + one f16 scale per ``block``; the padding lanes are a
tiling artifact and are trimmed before anything ships.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.qpack import kernel


def _check(bits: int, block: int):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if block < 2 or block % 2:
        raise ValueError(f"block must be even and >= 2, got {block}")


def _to_rows(x, block: int):
    """(..., N) -> float32 (R, Np), padded with zeros to the block
    multiple, + the leading shape and N."""
    lead, N = tuple(x.shape[:-1]), x.shape[-1]
    rows = x.float().reshape(-1, N)
    pad = (-N) % block
    return (F.pad(rows, (0, pad)) if pad else rows.contiguous()), lead, N


def quantize_blocks(x, *, bits: int = 8, block: int = 128):
    """x (..., N) -> (payload, scales).  payload: int8 codes (..., Np) for
    bits=8, packed uint8 nibbles (..., Np // 2) for bits=4 (Np = N padded
    to ``block``); scales: float16 (..., Np // block)."""
    _check(bits, block)
    rows, lead, _ = _to_rows(x, block)
    q, s = kernel.quant_flat(rows, qmax=2 ** (bits - 1) - 1, block=block)
    if bits == 4:
        q = kernel.pack4_flat(q)
    return q.reshape(lead + q.shape[1:]), s.reshape(lead + s.shape[1:])


def roundtrip_blocks(x, *, bits: int = 8, block: int = 128):
    """Quantize then dequantize, two launches: the lossy wire image without
    the int4 nibble pack and unpack (a bit-exact identity).  float32
    (..., N)."""
    _check(bits, block)
    rows, lead, n = _to_rows(x, block)
    q, s = kernel.quant_flat(rows, qmax=2 ** (bits - 1) - 1, block=block)
    out = kernel.dequant_flat(q, s, block=block)
    return out[:, :n].contiguous().reshape(lead + (n,))


def dequantize_blocks(payload, scales, *, n: int, bits: int = 8,
                      block: int = 128):
    """Inverse of :func:`quantize_blocks`: float32 (..., n), the padding
    lanes trimmed."""
    _check(bits, block)
    lead = tuple(payload.shape[:-1])
    p = payload.reshape(-1, payload.shape[-1])
    s = scales.reshape(-1, scales.shape[-1])
    q = kernel.unpack4_flat(p) if bits == 4 else p
    out = kernel.dequant_flat(q, s, block=block)
    return out[:, :n].contiguous().reshape(lead + (n,))
