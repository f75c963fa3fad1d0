"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block (a port of
``repro.models.ssm``): the full-sequence forward.

The chunked SSD scan runs through the ``ssd_scan`` kernel when
``use_kernel`` is set, else through the reference's chunked algorithm.
The causal depthwise conv is k shift-and-accumulate steps, as in the
reference.  The decode path and the prefill state (``return_state``) belong
to the serving slice and raise.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.models.config import ArchConfig


def causal_depthwise_conv(x, w):
    """x: (B, T, C); w: (k, C) -> (B, T, C); y[t] = sum_j w[j] * x[t-k+1+j]."""
    k = w.shape[0]
    y = x * w[k - 1]
    for j in range(k - 1):
        shift = k - 1 - j
        y = y + F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]] * w[j]
    return y


@dataclasses.dataclass(frozen=True)
class Mamba2Block(nn.Module):
    cfg: ArchConfig
    use_kernel: bool = False

    @property
    def dims(self):
        c = self.cfg
        d_in = c.d_inner
        nh = c.resolved_ssm_heads
        return d_in, nh, d_in // nh, c.ssm_state

    def init(self, gen):
        c = self.cfg
        d_in, nh, hd, ds = self.dims
        dev, pd = gen.device, c.param_dtype

        def dense(o):
            return nn.Dense(c.d_model, o, use_bias=False, dtype=pd).init(gen)

        def conv(ch):
            return (0.3 * torch.randn((c.conv_kernel, ch), generator=gen, device=dev)).to(pd)

        return {
            "z_proj": dense(d_in),
            "x_proj": dense(d_in),
            "b_proj": dense(ds),
            "c_proj": dense(ds),
            "dt_proj": dense(nh),
            "conv": {"x": conv(d_in), "b": conv(ds), "c": conv(ds)},
            "ssd": {
                "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)).to(pd),
                "dt_bias": torch.zeros(nh, dtype=pd, device=dev),
                "D": torch.ones(nh, dtype=pd, device=dev),
            },
            "norm": nn.RMSNorm(d_in, dtype=pd).init(gen),
            "out_proj": nn.Dense(d_in, c.d_model, use_bias=False, dtype=pd).init(gen),
        }

    def _project(self, params, u):
        dt_ = self.cfg.dtype
        return tuple(u @ params[k]["w"].to(dt_)
                     for k in ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"))

    def apply(self, params, u, *, return_state: bool = False):
        """Full-sequence forward.  u: (B, T, d_model) -> (B, T, d_model)."""
        if return_state:
            raise NotImplementedError("the SSM prefill state is not ported yet: "
                                      "ROADMAP queue 1, slice 5 (serving)")
        c = self.cfg
        d_in, nh, hd, ds = self.dims
        Bsz, T, _ = u.shape
        z, x_raw, B_raw, C_raw, dt = self._project(params, u)
        x = F.silu(causal_depthwise_conv(x_raw, params["conv"]["x"].to(c.dtype)))
        Bm = F.silu(causal_depthwise_conv(B_raw, params["conv"]["b"].to(c.dtype)))
        Cm = F.silu(causal_depthwise_conv(C_raw, params["conv"]["c"].to(c.dtype)))
        x = x.reshape(Bsz, T, nh, hd)

        A = -torch.exp(params["ssd"]["A_log"].float())                      # (nh,)
        dt = F.softplus(dt.float() + params["ssd"]["dt_bias"].float())      # (B,T,nh)

        if self.use_kernel:
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            y = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=c.ssm_chunk)
        else:
            from repro_torch.kernels.ssd_scan.ref import ssd_ref
            y = ssd_ref(x, dt, A, Bm, Cm, chunk=c.ssm_chunk)

        y = y + x * params["ssd"]["D"].to(c.dtype)[None, None, :, None]
        y = y.reshape(Bsz, T, d_in)
        y = nn.RMSNorm(d_in).apply(params["norm"], y) * F.silu(z)
        return y @ params["out_proj"]["w"].to(c.dtype)
