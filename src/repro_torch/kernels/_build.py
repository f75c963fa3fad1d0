"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` of the checkout, and loaded with ``ctypes``.  A file
that does not include PyTorch's headers builds in seconds, where
``torch.utils.cpp_extension.load`` takes minutes.

The library name carries a digest of the source, of every header under
``csrc/`` (``*.cuh``, which a source may include) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Sources that need building are compiled in parallel, one ``nvcc`` each.

No ``--use_fast_math``: the quantizer divides (``rint(y / s)``), and an
approximate division moves codes that sit at .5 ties.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}   # name -> ctypes.CDLL; a library is loaded once per process


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns ``{name: seconds}`` for the ones
    compiled here.  Each library is written under a temporary name and
    renamed into place, so a concurrent reader never sees half a file."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.  ``signatures``
    maps each C entry to its ``argtypes``; every entry returns the
    ``cudaError_t`` of its launch as an int."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def require_cuda(what: str, *tensors) -> None:
    """Refuse what a kernel cannot take: every tensor on one CUDA device,
    contiguous, and plain (a kernel reads local memory: a DTensor enters
    through ``repro_torch.dist.sharding.local_kernel``).
    Dtypes and shapes are the wrapper's own check."""
    from torch.distributed.tensor import DTensor
    dev = tensors[0].device
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{what}: the kernel takes the local shards of a DTensor "
                            f"(run it under local_kernel), got {t.placements}")
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: all tensors must be on one CUDA device "
                             f"(or all on the CPU), got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors; "
                             f"got strides {t.stride()} for {tuple(t.shape)}")


def check_launch(err: int, what: str) -> None:
    """Raise when a C entry reports a failed launch (``cudaGetLastError``)."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
