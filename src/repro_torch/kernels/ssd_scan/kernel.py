"""Wrapper of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

On CPU tensors ``ssd_bthd`` computes the plain version; on CUDA tensors it
launches the kernel or raises.  The kernel is forward only, as the TPU
kernel it replaces: a CUDA input that requires grad raises.

A scan is three CUDA launches on the caller's stream, the kernel's three
phases (chunk states, state pass, chunk outputs), or one when T is a
single chunk and no final state is asked for; they share a float32
workspace of the chunk states that the wrapper allocates on x's device.
``return_final_state=True`` also returns the state after the last step,
(Bsz, nh, hd, ds) float32 in ``ssd_ref``'s layout, which the state pass
writes.  ``ssd_bthd.launches`` counts scans, one
per call that launches them, and nothing else.  ``ssd_phase`` launches one
phase alone and ``kernel_attrs`` reads a phase's compiled kernel: both are
for measuring the kernel, and neither is counted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"ssd_scan_f32": _ARGS, "ssd_scan_bf16": _ARGS,
               "ssd_scan_phase": [_I, _I, *_ARGS],
               "ssd_scan_smem_bytes": [_I, _I, _I, _I],
               "ssd_scan_attrs": [_I, _I, ctypes.POINTER(_I)]}
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
MAX_DIM = 128           # largest chunk, head_dim and state the kernel takes
SMEM_LIMIT = 232_448    # shared memory a block may use on the H100


def ssd_bthd(x, dt, A, B, C, *, chunk: int = 128, return_final_state: bool = False):
    """x: (Bsz, T, nh, hd); dt: (Bsz, T, nh) float32; A: (nh,) float32;
    B, C: (Bsz, T, ds) in x's dtype.  T must be a multiple of
    ``min(chunk, T)``.  Returns (Bsz, T, nh, hd) in x's dtype, and with
    ``return_final_state`` also the (Bsz, nh, hd, ds) float32 final state."""
    if x.dim() != 4 or dt.shape != x.shape[:3] or A.shape != x.shape[2:3] or \
            B.dim() != 3 or B.shape != C.shape or B.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd takes x (Bsz, T, nh, hd), dt (Bsz, T, nh), A (nh,), "
                         f"B and C (Bsz, T, ds); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_ref(x, dt, A, B, C, chunk=chunk, return_final_state=return_final_state)
    lib, Q = _checked(x, dt, A, B, C, chunk)
    y = torch.empty_like(x)
    ws = workspace(x, B, chunk=Q, final=return_final_state)
    state = None
    if return_final_state:
        Bsz, _, nh, hd = x.shape
        state = torch.empty((Bsz, nh, hd, B.shape[-1]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY[x.dtype])(*_args(x, dt, A, B, C, y, ws, state, Q))
    _build.check_launch(err, "ssd")
    ssd_bthd.launches += 1
    return (y, state) if return_final_state else y


ssd_bthd.launches = 0


def _checked(x, dt, A, B, C, chunk):
    """Refuse what the kernel cannot take (CUDA tensors of the shapes
    ``ssd_bthd`` checks); return the loaded library and the chunk."""
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
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd reads x, B and C 16 bytes at a time: each must start on a "
                         "16-byte boundary")
    lib = _build.load("ssd_scan", _SIGNATURES)
    smem = lib.ssd_scan_smem_bytes(Q, hd, ds, int(x.dtype == torch.bfloat16))
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd at chunk {Q}, head_dim {hd}, state {ds} in {x.dtype} "
                         f"needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    return lib, Q


def workspace(x, B, *, chunk: int, final: bool = False):
    """An uninitialised float32 workspace for a scan of ``x``: the (ds, hd)
    state of every chunk but the last (and of the last too when the scan
    returns its ``final`` state), per batch row and head, then their
    L_last (at least one element, so that its pointer is valid)."""
    return torch.empty(_workspace_numel(x, B, min(chunk, x.shape[1]), final),
                       dtype=torch.float32, device=x.device)


def _workspace_numel(x, B, Q, final=False):
    Bsz, T, nh, hd = x.shape
    return max(Bsz * (T // Q - 1 + int(final)) * nh * (B.shape[-1] * hd + 1), 1)


def _args(x, dt, A, B, C, y, ws, state, Q):
    Bsz, T, nh, hd = x.shape
    return (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), ws.data_ptr(), 0 if state is None else state.data_ptr(),
            Bsz, T, nh, hd, B.shape[-1], Q, torch.cuda.current_stream().cuda_stream)


def ssd_phase(phase: int, x, dt, A, B, C, y, ws, *, chunk: int = 128) -> None:
    """Launch phase 1 (chunk states), 2 (state pass) or 3 (chunk outputs)
    alone, into ``y`` (like ``x``) and ``ws`` (from ``workspace``); each
    phase reads what the ones before it wrote.  For timing a phase: not
    counted in ``ssd_bthd.launches``."""
    lib, Q = _checked(x, dt, A, B, C, chunk)
    if y.shape != x.shape or y.dtype != x.dtype or y.device != x.device or \
            ws.dtype != torch.float32 or ws.device != x.device or \
            ws.numel() < _workspace_numel(x, B, Q):
        raise ValueError("ssd_phase takes y like x and ws from workspace(x, B, chunk)")
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_phase(phase, int(x.dtype == torch.bfloat16),
                                 *_args(x, dt, A, B, C, y, ws, None, Q))
    _build.check_launch(err, f"ssd phase {phase}")


def kernel_attrs(phase: int, dtype) -> dict:
    """What the compiler and the card make of phase 1, 2 or 3 at the main
    path's instantiation (chunk 128, head_dim 64, state 128) for x of
    ``dtype``: registers and local (spill) bytes a thread, dynamic shared
    bytes a block, blocks resident on an SM.  Launches nothing."""
    if phase not in (1, 2, 3) or dtype not in _ENTRY:
        raise ValueError(f"kernel_attrs takes phase 1, 2 or 3 and float32 or bfloat16, "
                         f"got {phase}, {dtype}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_attrs reads the card's compiled kernel: needs CUDA")
    out = (ctypes.c_int * 4)()
    _build.check_launch(_build.load("ssd_scan", _SIGNATURES).ssd_scan_attrs(
        phase, int(dtype == torch.bfloat16), out), "ssd attrs")
    return dict(zip(("num_regs", "local_bytes", "smem_bytes", "blocks_per_sm"), out))
