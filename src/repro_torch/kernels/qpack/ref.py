"""Plain PyTorch versions of the qpack kernels (a port of
``repro.kernels.qpack.ref``).

Every op repeats the kernel's arithmetic (the same f16 scale, rounding and
nibble order), so kernel and plain version agree bit for bit, and both
agree bit for bit with the reference.
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


def quant_blocks_ref(x: torch.Tensor, *, qmax: int, block: int):
    """x (R, N), N a multiple of ``block`` -> (codes int8 (R, N), scales
    f16 (R, N // block)).  Codes are ``clip(round_half_even(x / s), ±qmax)``
    with ``s`` the decode value of the block's f16 scale."""
    R, N = x.shape
    tiles = x.float().reshape(R, N // block, block)
    amax = tiles.abs().amax(dim=-1, keepdim=True)
    s_wire, s_dec = _wire_scale(amax, qmax)
    q = torch.clamp(torch.round(tiles / s_dec), -qmax, qmax).to(torch.int8)
    return q.reshape(R, N), s_wire[..., 0]


def dequant_blocks_ref(q: torch.Tensor, scales: torch.Tensor, *,
                       block: int) -> torch.Tensor:
    """codes (R, N) + f16 scales (R, N // block) -> f32 (R, N); a zero
    scale decodes with 1."""
    R, N = q.shape
    s = scales.float()
    s = torch.where(s > 0, s, torch.ones((), dtype=torch.float32,
                                         device=s.device))[..., None]
    return (q.float().reshape(R, N // block, block) * s).reshape(R, N)


def roundtrip_blocks_ref(x: torch.Tensor, *, qmax: int, block: int) -> torch.Tensor:
    """x (R, N), N a multiple of ``block``: the block-scaled quantize then
    dequantize of every row.  The values pass through the int8 codes, as
    on the wire, so a code of 0 decodes to +0 (a float rounding of a small
    negative quotient would keep -0)."""
    q, s = quant_blocks_ref(x, qmax=qmax, block=block)
    return dequant_blocks_ref(q, s, block=block)


def pack4_ref(q: torch.Tensor) -> torch.Tensor:
    """int8 codes (R, N) in [-7, 7], N even -> uint8 (R, N // 2), low
    nibble first.  The codes' bits are reinterpreted, not converted."""
    pairs = (q.view(torch.uint8) & 0xF).reshape(q.shape[0], -1, 2)
    return pairs[:, :, 0] | (pairs[:, :, 1] << 4)


def unpack4_ref(p: torch.Tensor) -> torch.Tensor:
    """uint8 (R, M) -> sign-extended int8 codes (R, 2 M)."""
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[0], -1)
