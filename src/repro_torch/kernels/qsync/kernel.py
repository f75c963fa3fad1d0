"""Wrapper of the CUDA fused coded-sync kernel (``csrc/qsync.cu``).

On CPU tensors ``qsync_flat`` computes the plain version; on CUDA tensors
it launches the kernel or raises.  ``qsync_flat.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsync.ref import qsync_flat_ref

_P = ctypes.c_void_p
_SIGNATURES = {"qsync_f32": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]}


def qsync_flat(weights, stacked, ef=None, ef_down=None, *, qmax: int,
               block: int = 128):
    """``weights`` float32 shaped like the agent grid ((P, A) or (B,)),
    ``stacked`` (B, N) float32 with N a multiple of ``block``; optional
    uplink residual ``ef`` (B, N) and downlink residual ``ef_down`` (N,).
    Returns ``(synced (N,), new_ef | None, new_ef_down | None)``."""
    B = weights.numel()
    if stacked.dim() != 2 or stacked.shape[0] != B:
        raise ValueError(f"stacked must be ({B}, N) for {tuple(weights.shape)} "
                         f"weights, got {tuple(stacked.shape)}")
    N = stacked.shape[1]
    if N % block:
        raise ValueError(f"N={N} is not a multiple of block={block}")
    if ef is not None and ef.shape != stacked.shape:
        raise ValueError(f"ef must be {tuple(stacked.shape)}, got {tuple(ef.shape)}")
    if ef_down is not None and ef_down.shape != (N,):
        raise ValueError(f"ef_down must be ({N},), got {tuple(ef_down.shape)}")
    given = [t for t in (weights, stacked, ef, ef_down) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        return qsync_flat_ref(weights, stacked, ef, ef_down, qmax=qmax,
                              block=block)
    _build.require_cuda("qsync", *given)
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError("qsync takes float32 tensors only, got "
                        f"{[t.dtype for t in given]}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"the qsync kernel runs one thread per column of a "
                         f"block: block must be a multiple of 32 in "
                         f"[32, 1024], got {block}")
    synced = torch.empty(N, dtype=torch.float32, device=stacked.device)
    new_ef = torch.empty_like(stacked) if ef is not None else None
    new_ed = torch.empty_like(synced) if ef_down is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _build.load("qsync", _SIGNATURES)
    with torch.cuda.device(stacked.device):
        err = lib.qsync_f32(weights.data_ptr(), stacked.data_ptr(), ptr(ef),
                            ptr(ef_down), synced.data_ptr(), ptr(new_ef),
                            ptr(new_ed), B, N, block, qmax,
                            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "qsync")
    qsync_flat.launches += 1
    return synced, new_ef, new_ed


qsync_flat.launches = 0
