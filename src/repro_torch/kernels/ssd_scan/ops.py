"""Public SSD entry point in model layout (a port of
``repro.kernels.ssd_scan.ops``)."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_bthd


def ssd(x, dt, A, B, C, *, chunk: int = 128, return_final_state: bool = False):
    """Mamba2 SSD scan.  x: (Bsz, T, nh, hd); dt: (Bsz, T, nh); A: (nh,);
    B, C: (Bsz, T, ds) -> (Bsz, T, nh, hd) (and the (Bsz, nh, hd, ds)
    float32 state after the last step if ``return_final_state``).  The
    kernel takes contiguous tensors; the model's inputs are made so here."""
    return ssd_bthd(x.contiguous(), dt.contiguous(), A.contiguous(), B.contiguous(),
                    C.contiguous(), chunk=chunk, return_final_state=return_final_state)
