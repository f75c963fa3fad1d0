"""Plain PyTorch version of the SSD scan kernel (a port of
``repro.kernels.ssd_scan.ref``).

Recurrence (per batch b, head h):
    S_t = a_t * S_{t-1} + dt_t * x_t ⊗ B_t          S in R^{hd x ds}
    y_t = C_t · S_t
with a_t = exp(A_h * dt_t), A_h < 0.

Chunked form (chunk Q): inclusive log-decay cumsum L within each chunk,
  intra:  y_i += Σ_{j<=i} exp(L_i - L_j) (C_i·B_j) dt_j x_j
  local end state:  S_loc = Σ_j exp(L_Q - L_j) dt_j x_j ⊗ B_j
  inter (scan over chunks):  S_c = exp(L_Q) S_{c-1} + S_loc,
                             y_i += C_i · (exp(L_i) S_{c-1})
All math in float32; the output is cast back to x's dtype.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C, *, chunk: int = 128, return_final_state: bool = False):
    """x: (B,T,nh,hd); dt: (B,T,nh) f32 post-softplus; A: (nh,) f32 (<0);
    B, C: (B,T,ds).  Returns (B,T,nh,hd) in x.dtype (plus the final
    (B,nh,hd,ds) f32 state if requested)."""
    Bsz, T, nh, hd = x.shape
    ds = B.shape[-1]
    Q = int(min(chunk, T))
    if T % Q:
        raise ValueError(f"T={T} not divisible by chunk={Q}")
    NC = T // Q

    xf = x.float().reshape(Bsz, NC, Q, nh, hd)
    dtf = dt.float().reshape(Bsz, NC, Q, nh)
    Bf = B.float().reshape(Bsz, NC, Q, ds)
    Cf = C.float().reshape(Bsz, NC, Q, ds)

    la = A[None, None, None, :] * dtf                    # log a_t  (B,NC,Q,nh)
    L = torch.cumsum(la, dim=2)                          # inclusive
    Llast = L[:, :, -1:, :]                              # (B,NC,1,nh)

    # ---- intra-chunk (quadratic within chunk) ----
    scores = torch.einsum("bnqs,bnps->bnqp", Cf, Bf)     # (B,NC,Q,Q) q=i,p=j
    # valid (j <= i) log-decays are <= 0; clamp the masked j > i entries so
    # exp() cannot overflow
    diff = torch.clamp(L[:, :, :, None, :] - L[:, :, None, :, :], max=0.0)
    decay = torch.exp(diff)                              # (B,NC,Q,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = torch.where(mask[None, None, :, :, None], scores[..., None] * decay, 0.0)
    y_intra = torch.einsum("bnqph,bnphd->bnqhd", M, dtf[..., None] * xf)

    # ---- chunk-local end states ----
    w = torch.exp(Llast - L) * dtf                       # (B,NC,Q,nh)
    S_loc = torch.einsum("bnqhd,bnqs->bnhds", w[..., None] * xf, Bf)  # (B,NC,nh,hd,ds)
    chunk_decay = torch.exp(Llast[:, :, 0, :])           # (B,NC,nh)

    # ---- inter-chunk recurrence ----
    S = torch.zeros((Bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
    S_prevs = []
    for c in range(NC):
        S_prevs.append(S)
        S = chunk_decay[:, c, :, None, None] * S + S_loc[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)                # (B,NC,nh,hd,ds)

    y_inter = torch.einsum("bnqs,bnqh,bnhds->bnqhd", Cf, torch.exp(L), S_prevs)

    y = (y_intra + y_inter).reshape(Bsz, T, nh, hd).to(x.dtype)
    if return_final_state:
        return y, S
    return y


def ssd_decode_ref(state, x1, dt1, A, B1, C1):
    """One recurrent step.  state: (B,nh,hd,ds) f32; x1: (B,nh,hd);
    dt1: (B,nh); B1, C1: (B,ds).  Returns (y1, new_state)."""
    decay = torch.exp(A[None] * dt1)                     # (B,nh)
    new_state = (decay[..., None, None] * state
                 + dt1[..., None, None]
                 * x1.float()[..., None]
                 * B1.float()[:, None, None, :])
    y1 = torch.einsum("bhds,bs->bhd", new_state, C1.float())
    return y1.to(x1.dtype), new_state
