"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

On CPU tensors ``flash_attention_bhsd`` computes the plain version; on
CUDA tensors it launches the kernel or raises.  The kernel is forward
only, as the TPU kernel it replaces: a CUDA input that requires grad
raises.  ``flash_attention_bhsd.launches`` counts kernel launches and
nothing else.  bfloat16 inputs launch the tensor-core kernel
(``flash_fwd_tc``: 64 queries x 64 keys, 32 keys at head_dim 256, p split
into two bfloat16 halves for p.v), float32 inputs the float32 one (64 x
64 on the CUDA cores); ``bf16_kernel_attrs`` reports the first's
registers, spills and occupancy.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS,
               "flash_attention_bf16_attrs": [_I, ctypes.POINTER(_I)]}
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, nh, T, hd); k/v: (B, nkv, S, hd), nh a multiple of nkv.
    Returns (B, nh, T, hd) in q's dtype."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            (q.shape[0], q.shape[3]) != (k.shape[0], k.shape[3]) or \
            q.shape[1] % k.shape[1]:
        raise ValueError(f"flash attention takes q (B, nh, T, hd) and k, v "
                         f"(B, nkv, S, hd) with nkv dividing nh, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window)
    _build.require_cuda("flash attention", q, k, v)
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash attention is forward only (the TPU kernel has "
                           "no backward); call it under torch.no_grad()")
    B, nh, T, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash attention: the bfloat16 kernel copies 16-byte rows "
                             "and takes tensors whose data starts on a 16-byte boundary")
        if S * hd >= 2 ** 31:
            raise ValueError(f"flash attention: the bfloat16 kernel addresses a head's "
                             f"keys in 32 bits, S * head_dim < 2^31, got {S} * {hd}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, nh, nkv,
            T, S, hd, 1.0 / math.sqrt(hd), int(causal), int(window),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash attention")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0


def bf16_kernel_attrs(hd: int) -> dict:
    """What the compiler and the card make of the bfloat16 kernel at
    head_dim ``hd``: registers and local (spill) bytes a thread, dynamic
    shared bytes a block, blocks resident on an SM.  Launches nothing."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {HEAD_DIMS}, got {hd}")
    if not torch.cuda.is_available():
        raise RuntimeError("bf16_kernel_attrs reads the card's compiled kernel: needs CUDA")
    out = (ctypes.c_int * 4)()
    _build.check_launch(_build.load("flash_attention", _SIGNATURES)
                        .flash_attention_bf16_attrs(hd, out), "flash attention attrs")
    return dict(zip(("num_regs", "local_bytes", "smem_bytes", "blocks_per_sm"), out))
