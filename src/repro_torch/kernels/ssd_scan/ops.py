"""Public SSD entry point in model layout (a port of
``repro.kernels.ssd_scan.ops``)."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_bthd


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """Mamba2 SSD scan.  x: (Bsz, T, nh, hd); dt: (Bsz, T, nh); A: (nh,);
    B, C: (Bsz, T, ds) -> (Bsz, T, nh, hd).  The kernel takes contiguous
    tensors; the model's inputs are made so here."""
    return ssd_bthd(x.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(),
                    C.contiguous(), chunk=chunk)
