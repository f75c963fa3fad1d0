"""Plain PyTorch version of the flash-attention kernel (a port of
``repro.kernels.flash_attention.ref``): GQA + causal + sliding window, all
in float32, the output cast back to q's dtype."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, nh, T, hd); k/v: (B, nkv, S, hd) -> (B, nh, T, hd)."""
    B, nh, T, hd = q.shape
    _, nkv, S, _ = k.shape
    group = nh // nkv
    qg = q.reshape(B, nkv, group, T, hd).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return o.reshape(B, nh, T, hd).to(q.dtype)
