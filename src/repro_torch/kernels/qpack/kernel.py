"""Wrappers of the CUDA qpack kernels (``csrc/qpack.cu``).

On CPU tensors each wrapper computes its plain version (``ref.py``); on
CUDA tensors it launches its kernel or raises.  ``<wrapper>.launches``
counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qpack.ref import (dequant_blocks_ref, pack4_ref,
                                          quant_blocks_ref, unpack4_ref)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {"qpack_quant": [_P, _P, _P, _LL, _LL, _I, _I, _P],
               "qpack_dequant": [_P, _P, _P, _LL, _LL, _I, _P],
               "qpack_pack4": [_P, _P, _LL, _P],
               "qpack_unpack4": [_P, _P, _LL, _P],
               "qpack_attrs": [_I, ctypes.POINTER(_I)]}
# The compiled kernels, in the order of the C entry ``qpack_attrs``: the
# vector and general routes of dequant, pack4 and unpack4 are kernels of
# their own.
KERNELS = ("quant", "dequant", "dequant_general", "pack4", "pack4_general",
           "unpack4", "unpack4_general")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_dtype(what, t, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{what} takes {dtype}, got {t.dtype}")


def _check_rows(what, t, multiple):
    if t.dim() != 2 or t.shape[1] % multiple:
        raise ValueError(f"{what} takes (R, N) with N a multiple of "
                         f"{multiple}, got {tuple(t.shape)}")


def _check_block(block):
    if block < 2 or block % 2:
        raise ValueError(f"block must be even and >= 2, got {block}")


def _launch(entry, what, device, *args):
    lib = _build.load("qpack", _SIGNATURES)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, what)


def quant_flat(x: torch.Tensor, *, qmax: int, block: int = 128):
    """x (R, N) float32, N a multiple of ``block`` -> (codes int8 (R, N),
    scales float16 (R, N // block))."""
    _check_block(block)
    _check_rows("quant", x, block)
    _check_dtype("quant", x, torch.float32)
    if _on_cpu(x):
        return quant_blocks_ref(x, qmax=qmax, block=block)
    _build.require_cuda("quant", x)
    R, N = x.shape
    q = torch.empty((R, N), dtype=torch.int8, device=x.device)
    s = torch.empty((R, N // block), dtype=torch.float16, device=x.device)
    _launch("qpack_quant", "quant", x.device, x.data_ptr(), q.data_ptr(),
            s.data_ptr(), R, N, block, qmax)
    quant_flat.launches += 1
    return q, s


def dequant_flat(q: torch.Tensor, scales: torch.Tensor, *,
                 block: int = 128) -> torch.Tensor:
    """codes int8 (R, N) + scales float16 (R, N // block) -> float32
    (R, N)."""
    _check_block(block)
    _check_rows("dequant", q, block)
    R, N = q.shape
    if tuple(scales.shape) != (R, N // block):
        raise ValueError(f"scales must be ({R}, {N // block}) for codes "
                         f"{tuple(q.shape)}, got {tuple(scales.shape)}")
    _check_dtype("dequant", q, torch.int8)
    _check_dtype("dequant", scales, torch.float16)
    if _on_cpu(q, scales):
        return dequant_blocks_ref(q, scales, block=block)
    _build.require_cuda("dequant", q, scales)
    out = torch.empty((R, N), dtype=torch.float32, device=q.device)
    _launch("qpack_dequant", "dequant", q.device, q.data_ptr(),
            scales.data_ptr(), out.data_ptr(), R, N, block)
    dequant_flat.launches += 1
    return out


def pack4_flat(q: torch.Tensor) -> torch.Tensor:
    """int8 codes (R, N) in [-7, 7], N even -> uint8 (R, N // 2), two codes
    a byte, low nibble first."""
    _check_rows("pack4", q, 2)
    _check_dtype("pack4", q, torch.int8)
    if _on_cpu(q):
        return pack4_ref(q)
    _build.require_cuda("pack4", q)
    R, N = q.shape
    p = torch.empty((R, N // 2), dtype=torch.uint8, device=q.device)
    _launch("qpack_pack4", "pack4", q.device, q.data_ptr(), p.data_ptr(),
            R * (N // 2))
    pack4_flat.launches += 1
    return p


def unpack4_flat(p: torch.Tensor) -> torch.Tensor:
    """uint8 (R, M) -> sign-extended int8 codes (R, 2 M)."""
    _check_rows("unpack4", p, 1)
    _check_dtype("unpack4", p, torch.uint8)
    if _on_cpu(p):
        return unpack4_ref(p)
    _build.require_cuda("unpack4", p)
    R, M = p.shape
    q = torch.empty((R, 2 * M), dtype=torch.int8, device=p.device)
    _launch("qpack_unpack4", "unpack4", p.device, p.data_ptr(), q.data_ptr(),
            R * M)
    unpack4_flat.launches += 1
    return q


def kernel_attrs(name: str) -> dict:
    """Registers and local (spill) bytes a thread of the compiled kernel
    ``name`` (one of ``KERNELS``).  Launches nothing."""
    if name not in KERNELS:
        raise ValueError(f"kernel_attrs takes one of {KERNELS}, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_attrs reads the card's compiled kernel: needs CUDA")
    out = (ctypes.c_int * 2)()
    _build.check_launch(_build.load("qpack", _SIGNATURES).qpack_attrs(
        KERNELS.index(name), out), "qpack attrs")
    return dict(zip(("num_regs", "local_bytes"), out))


quant_flat.launches = 0
dequant_flat.launches = 0
pack4_flat.launches = 0
unpack4_flat.launches = 0
