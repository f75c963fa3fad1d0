"""Wrapper of the CUDA fedavg kernel (``csrc/fedavg.cu``).

On CPU tensors ``fedavg_flat`` computes the plain version; on CUDA tensors
it launches the kernel or raises.  ``fedavg_flat.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fedavg.ref import fedavg_flat_ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {"fedavg_f32": _ARGS, "fedavg_bf16": _ARGS}
_ENTRY = {torch.float32: "fedavg_f32", torch.bfloat16: "fedavg_bf16"}


def fedavg_flat(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` float32 shaped like the agent grid ((B,) or (P, A)),
    ``stacked`` (B, N) float32 or bfloat16.  Returns the (N,) weighted sum
    over agents in ``stacked.dtype`` (float32 accumulation)."""
    B = weights.numel()
    if stacked.dim() != 2 or stacked.shape[0] != B:
        raise ValueError(f"stacked must be ({B}, N) for {tuple(weights.shape)} "
                         f"weights, got {tuple(stacked.shape)}")
    if stacked.device.type == "cpu" and weights.device.type == "cpu":
        return fedavg_flat_ref(weights, stacked)
    _build.require_cuda("fedavg", stacked, weights)
    if stacked.dtype not in _ENTRY or weights.dtype != torch.float32:
        raise TypeError(f"fedavg takes float32 weights and float32 or "
                        f"bfloat16 data, got {weights.dtype} and {stacked.dtype}")
    N = stacked.shape[1]
    out = torch.empty(N, dtype=stacked.dtype, device=stacked.device)
    lib = _build.load("fedavg", _SIGNATURES)
    with torch.cuda.device(stacked.device):
        err = getattr(lib, _ENTRY[stacked.dtype])(
            weights.data_ptr(), stacked.data_ptr(), out.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "fedavg")
    fedavg_flat.launches += 1
    return out


fedavg_flat.launches = 0
