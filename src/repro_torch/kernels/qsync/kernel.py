"""Wrappers of the two CUDA kernels of ``csrc/qsync.cu``: the fused coded
sync (``qsync_flat``) and the fused Adam step with the uplink quantize
(``adam_sync_flat``).

On CPU tensors each wrapper computes its plain version; on CUDA tensors it
launches the kernel or raises.  ``qsync_flat.launches`` and
``adam_sync_flat.launches`` count kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qsync.ref import adam_sync_flat_ref, qsync_flat_ref

_P, _F = ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {"qsync_f32": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
               "adam_sync_f32": [_P] * 10 + [ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_int, ctypes.c_int,
                                             _F, _F, _F, _F, _F, _P]}


def _check_block(what: str, block: int):
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"the {what} kernel runs one thread per column of a "
                         f"block: block must be a multiple of 32 in "
                         f"[32, 1024], got {block}")


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
    _check_block("qsync", block)
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


def adam_sync_flat(hyper, params, grads, mu, nu, *, b1: float, b2: float,
                   eps: float, qmax: int, block: int = 128):
    """``hyper`` (1, 3) float32 [lr, bc1, bc2] on the params' device;
    ``params``, ``grads``, ``mu``, ``nu`` (B, N) float32 with N a multiple
    of ``block``.  Returns ``(new_params, new_mu, new_nu, codes int8 (B, N),
    scales f16 (B, N // block))``."""
    if params.dim() != 2:
        raise ValueError(f"params must be (B, N), got {tuple(params.shape)}")
    B, N = params.shape
    for name, t in (("grads", grads), ("mu", mu), ("nu", nu)):
        if t.shape != params.shape:
            raise ValueError(f"{name} must be {tuple(params.shape)}, "
                             f"got {tuple(t.shape)}")
    if tuple(hyper.shape) != (1, 3):
        raise ValueError(f"hyper must be (1, 3), got {tuple(hyper.shape)}")
    if N % block:
        raise ValueError(f"N={N} is not a multiple of block={block}")
    given = (hyper, params, grads, mu, nu)
    if any(t.dtype != torch.float32 for t in given):
        raise TypeError("adam_sync takes float32 tensors only, got "
                        f"{[t.dtype for t in given]}")
    if all(t.device.type == "cpu" for t in given):
        return adam_sync_flat_ref(hyper, params, grads, mu, nu, b1=b1, b2=b2,
                                  eps=eps, qmax=qmax, block=block)
    _build.require_cuda("adam_sync", *given)
    _check_block("adam_sync", block)
    if B > 65535:
        raise ValueError(f"the adam_sync kernel runs one grid row per agent: "
                         f"B must be at most 65535, got {B}")
    outs = [torch.empty_like(params) for _ in range(3)]
    codes = torch.empty((B, N), dtype=torch.int8, device=params.device)
    scales = torch.empty((B, N // block), dtype=torch.float16, device=params.device)
    lib = _build.load("qsync", _SIGNATURES)
    with torch.cuda.device(params.device):
        # 1 - b1 and 1 - b2 are the host's double differences, rounded once
        # to float32 by ctypes, as PyTorch's scalar multiply rounds them
        err = lib.adam_sync_f32(*(t.data_ptr() for t in (*given, *outs, codes, scales)),
                                B, N, block, qmax, b1, 1 - b1, b2, 1 - b2, eps,
                                torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "adam_sync")
    adam_sync_flat.launches += 1
    return (*outs, codes, scales)


adam_sync_flat.launches = 0
