"""PyTorch and CUDA port of the FedGAN system in ``repro``.

Every subpackage has one twin in ``repro`` (``core/``, ``nn/``, ``optim/``,
``dist/``, ``kernels/<name>/``, ...).  Parameters stay dicts keyed exactly
like the JAX pytrees, in the JAX layouts (Dense ``w`` is ``(in, out)``,
conv weights HWIO, transpose-conv weights HWOI, activations NHWC), so
``repro_torch.convert`` maps a JAX state onto the port 1:1.

The port imports no JAX and nothing of ``repro``.  Its entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch

# The JAX reference computes in full float32.  cuDNN convolutions default to
# TF32 (about three decimal digits), so the port turns TF32 off for matrix
# products and convolutions alike, for every caller of the package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) raises when no GPU is present instead of silently
    running on the CPU; pass ``device="cpu"`` to run there on purpose."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' (CLI: "
            "--device cpu) to run the port on the CPU")
    return dev
