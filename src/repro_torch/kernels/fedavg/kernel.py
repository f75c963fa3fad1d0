"""Wrappers of the CUDA fedavg kernels (``csrc/fedavg.cu``).

On CPU tensors each wrapper computes its plain version; on CUDA tensors it
launches its kernel or raises.  Each wrapper's ``launches`` counts its
kernel's launches and nothing else:

* ``fedavg_flat``: the Pallas ``_fedavg_kernel``'s reduce, products and
  sum in float32 (float32 or bfloat16 data);
* ``fedavg_wire_flat``: the reference's ``weighted_mean`` in a bfloat16 or
  float16 leaf's own type (products rounded to it);
* ``fedavg_pod_flat``: the reference's ``average_intra_pod`` reduce, a
  fused multiply-add chain per pod, in a float32, bfloat16 or float16
  leaf's own type (bfloat16 and float16: the weights rounded to it, the
  chain in float32, the sum rounded to it once).  Its ``launches`` counts
  every pod launch, ``by_dtype`` each route's.

The wire and pod routes take any contiguous input, a view with a storage
offset included: the kernel realigns each row's 16-byte loads itself.
``kernel_attrs`` reads each of their compiled instantiations (``KERNELS``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fedavg.ref import (fedavg_flat_ref, fedavg_pod_low_ref,
                                            fedavg_pod_ref, fedavg_wire_ref)

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p]
_POD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {"fedavg_f32": _ARGS, "fedavg_bf16": _ARGS, "fedavg_wire_bf16": _ARGS,
               "fedavg_wire_f16": _ARGS, "fedavg_pod_f32": _POD_ARGS,
               "fedavg_pod_bf16": _POD_ARGS, "fedavg_pod_f16": _POD_ARGS,
               "fedavg_attrs": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]}
_ENTRY = {torch.float32: "fedavg_f32", torch.bfloat16: "fedavg_bf16"}
_WIRE_ENTRY = {torch.bfloat16: "fedavg_wire_bf16", torch.float16: "fedavg_wire_f16"}
_POD_ENTRY = {torch.float32: "fedavg_pod_f32", torch.bfloat16: "fedavg_pod_bf16",
              torch.float16: "fedavg_pod_f16"}
# The wire and pod routes' instantiations, in the order of the C entry
# ``fedavg_attrs``: per route, 1 to 8 agent rows unrolled, then any count
# in unrolled groups of 8 (``_g8``).
KERNELS = tuple(f"{route}_{rows}"
                for route in ("wire_bf16", "wire_f16", "pod", "pod_bf16", "pod_f16")
                for rows in (*range(1, 9), "g8"))


def _check_shape(weights, stacked):
    B = weights.numel()
    if stacked.dim() != 2 or stacked.shape[0] != B:
        raise ValueError(f"stacked must be ({B}, N) for {tuple(weights.shape)} "
                         f"weights, got {tuple(stacked.shape)}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(entry, weights, x, out, *dims):
    lib = _build.load("fedavg", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(weights.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  *dims, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, entry)


def fedavg_flat(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` float32 shaped like the agent grid ((B,) or (P, A)),
    ``stacked`` (B, N) float32 or bfloat16.  Returns the (N,) weighted sum
    over agents in ``stacked.dtype`` (float32 products and accumulation)."""
    _check_shape(weights, stacked)
    if _on_cpu(stacked, weights):
        return fedavg_flat_ref(weights, stacked)
    _build.require_cuda("fedavg", stacked, weights)
    if stacked.dtype not in _ENTRY or weights.dtype != torch.float32:
        raise TypeError(f"fedavg takes float32 weights and float32 or "
                        f"bfloat16 data, got {weights.dtype} and {stacked.dtype}")
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype, device=stacked.device)
    _launch(_ENTRY[stacked.dtype], weights, stacked, out, weights.numel(), stacked.shape[1])
    fedavg_flat.launches += 1
    return out


def fedavg_wire_flat(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` float32 shaped like the agent grid, ``stacked`` (B, N)
    bfloat16 or float16.  Returns the (N,) weighted sum in
    ``stacked.dtype``, computed as the reference computes it in that type:
    weights and products rounded to it, the sum in float32 in agent
    order."""
    _check_shape(weights, stacked)
    if _on_cpu(stacked, weights):
        return fedavg_wire_ref(weights, stacked)
    _build.require_cuda("fedavg_wire", stacked, weights)
    if stacked.dtype not in _WIRE_ENTRY or weights.dtype != torch.float32:
        raise TypeError(f"fedavg_wire takes float32 weights and bfloat16 or "
                        f"float16 data, got {weights.dtype} and {stacked.dtype}")
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype, device=stacked.device)
    _launch(_WIRE_ENTRY[stacked.dtype], weights, stacked, out, weights.numel(),
            stacked.shape[1])
    fedavg_wire_flat.launches += 1
    return out


def fedavg_pod_flat(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """``weights`` (P, A) float32 (any positive scale: each pod's row is
    normalised), ``stacked`` (P, A, N) float32, bfloat16 or float16.
    Returns the (P, N) per-pod weighted mean in ``stacked.dtype``, a fused
    multiply-add chain over the pod's agents in order (for bfloat16 and
    float16 the weights rounded to that type, the chain in float32, the sum
    rounded once)."""
    if weights.dim() != 2 or stacked.dim() != 3 or stacked.shape[:2] != weights.shape:
        raise ValueError(f"stacked must be (P, A, N) for {tuple(weights.shape)} "
                         f"weights, got {tuple(stacked.shape)}")
    if stacked.dtype not in _POD_ENTRY:
        raise TypeError(f"fedavg_pod takes float32, bfloat16 or float16 data, got "
                        f"{stacked.dtype}")
    if _on_cpu(stacked, weights):
        if stacked.dtype == torch.float32:
            return fedavg_pod_ref(weights, stacked)
        return fedavg_pod_low_ref(weights, stacked)
    _build.require_cuda("fedavg_pod", stacked, weights)
    if weights.dtype != torch.float32:
        raise TypeError(f"fedavg_pod takes float32 weights, got {weights.dtype}")
    P, A, N = stacked.shape
    out = torch.empty((P, N), dtype=stacked.dtype, device=stacked.device)
    _launch(_POD_ENTRY[stacked.dtype], weights, stacked, out, P, A, N)
    fedavg_pod_flat.launches += 1
    fedavg_pod_flat.by_dtype[stacked.dtype] += 1
    return out


class PodRoute:
    """The pod route's launches on ``dtype`` leaves (its share of
    ``fedavg_pod_flat.launches``), read and set as ``launches``, like a
    wrapper's own count."""

    def __init__(self, dtype):
        self.dtype = dtype

    @property
    def launches(self) -> int:
        return fedavg_pod_flat.by_dtype[self.dtype]

    @launches.setter
    def launches(self, n: int) -> None:
        fedavg_pod_flat.by_dtype[self.dtype] = n


def kernel_attrs(name: str) -> dict:
    """Registers and local (spill) bytes a thread, and blocks resident an
    SM, of the compiled instantiation ``name`` (one of ``KERNELS``).
    Launches nothing."""
    if name not in KERNELS:
        raise ValueError(f"kernel_attrs takes one of {KERNELS}, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_attrs reads the card's compiled kernel: needs CUDA")
    out = (ctypes.c_int * 3)()
    _build.check_launch(_build.load("fedavg", _SIGNATURES).fedavg_attrs(
        KERNELS.index(name), out), "fedavg attrs")
    return dict(zip(("num_regs", "local_bytes", "blocks_per_sm"), out))


fedavg_flat.launches = 0
fedavg_wire_flat.launches = 0
fedavg_pod_flat.launches = 0
fedavg_pod_flat.by_dtype = dict.fromkeys(_POD_ENTRY, 0)
