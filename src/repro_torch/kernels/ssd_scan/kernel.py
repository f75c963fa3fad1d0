"""Wrapper of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

On CPU tensors ``ssd_bthd`` computes the plain version; on CUDA tensors it
launches the kernel or raises.  The kernel is forward only, as the TPU
kernel it replaces: a CUDA input that requires grad raises.
``ssd_bthd.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"ssd_scan_f32": _ARGS, "ssd_scan_bf16": _ARGS,
               "ssd_scan_smem_bytes": [_I, _I, _I, _I]}
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
MAX_DIM = 128           # largest chunk, head_dim and state the kernel takes
SMEM_LIMIT = 232_448    # shared memory a block may use on the H100


def ssd_bthd(x, dt, A, B, C, *, chunk: int = 128):
    """x: (Bsz, T, nh, hd); dt: (Bsz, T, nh) float32; A: (nh,) float32;
    B, C: (Bsz, T, ds) in x's dtype.  T must be a multiple of
    ``min(chunk, T)``.  Returns (Bsz, T, nh, hd) in x's dtype."""
    if x.dim() != 4 or dt.shape != x.shape[:3] or A.shape != x.shape[2:3] or \
            B.dim() != 3 or B.shape != C.shape or B.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd takes x (Bsz, T, nh, hd), dt (Bsz, T, nh), A (nh,), "
                         f"B and C (Bsz, T, ds); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_ref(x, dt, A, B, C, chunk=chunk)
    _build.require_cuda("ssd", x, dt, A, B, C)
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype or \
            dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd takes x, B, C all float32 or all bfloat16 and dt, A "
                        f"float32; got x {x.dtype}, dt {dt.dtype}, A {A.dtype}, "
                        f"B {B.dtype}, C {C.dtype}")
    if any(t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError("ssd is forward only (the TPU kernel has no backward); "
                           "call it under torch.no_grad()")
    Bsz, T, nh, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"T={T} % chunk={Q} != 0")
    if max(Q, hd, ds) > MAX_DIM:
        raise ValueError(f"ssd takes chunk, head_dim and state up to {MAX_DIM}, "
                         f"got {Q}, {hd}, {ds}")
    lib = _build.load("ssd_scan", _SIGNATURES)
    smem = lib.ssd_scan_smem_bytes(Q, hd, ds, int(x.dtype == torch.bfloat16))
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd at chunk {Q}, head_dim {hd}, state {ds} in {x.dtype} "
                         f"needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), Bsz, T, nh, hd, ds, Q, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "ssd")
    ssd_bthd.launches += 1
    return y


ssd_bthd.launches = 0
