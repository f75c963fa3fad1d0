"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block (a port of
``repro.models.ssm``): the full-sequence forward.

The chunked SSD scan runs through the ``ssd_scan`` kernel when
``use_kernel`` is set, else through the reference's chunked algorithm.
The causal depthwise conv is k shift-and-accumulate steps, as in the
reference.  ``apply(return_state=True)`` (the prefill that builds the
decode cache) also returns the scan's final state: through the kernel
when ``use_kernel`` is set, else through the plain ``ssd_ref``, as the
reference does.  ``decode`` is the O(1) recurrent step on that cache.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.dist.sharding import (batch_spec, is_sharded, local_kernel, shard,
                                       whole_dims)
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
        """Full-sequence forward.  u: (B, T, d_model) -> (B, T, d_model).
        ``return_state=True`` additionally returns the decode cache."""
        c = self.cfg
        d_in, nh, hd, ds = self.dims
        Bsz, T, _ = u.shape
        z, x_raw, B_raw, C_raw, dt = self._project(params, u)
        x = F.silu(causal_depthwise_conv(x_raw, params["conv"]["x"].to(c.dtype)))
        Bm = F.silu(causal_depthwise_conv(B_raw, params["conv"]["b"].to(c.dtype)))
        Cm = F.silu(causal_depthwise_conv(C_raw, params["conv"]["c"].to(c.dtype)))
        x = x.reshape(Bsz, T, nh, hd)
        x = shard(x, *batch_spec(None, "model", None))

        A = -torch.exp(params["ssd"]["A_log"].float())                      # (nh,)
        dt = F.softplus(dt.float() + params["ssd"]["dt_bias"].float())      # (B,T,nh)

        if self.use_kernel:
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            y = _scan_on_shards(lambda *a: ssd_ops.ssd(*a, chunk=c.ssm_chunk,
                                                       return_final_state=return_state),
                                x, dt, A, Bm, Cm, return_state)
        else:
            from repro_torch.kernels.ssd_scan.ref import ssd_ref
            y = ssd_ref(x, dt, A, Bm, Cm, chunk=c.ssm_chunk, return_final_state=return_state)
        if return_state:
            y, state = y

        y = y + x * params["ssd"]["D"].to(c.dtype)[None, None, :, None]
        y = y.reshape(Bsz, T, d_in)
        y = nn.RMSNorm(d_in).apply(params["norm"], y) * F.silu(z)
        out = y @ params["out_proj"]["w"].to(c.dtype)
        out = shard(out, *batch_spec(None, None))
        if return_state:
            k = c.conv_kernel - 1
            return out, {"ssm": state, "conv_x": _tail_window(x_raw, k),
                         "conv_b": _tail_window(B_raw, k),
                         "conv_c": _tail_window(C_raw, k)}
        return out

    def init_cache(self, batch: int, *, device=None):
        """Zeroed decode cache: the SSM state in float32, the conv windows
        (the last conv_kernel - 1 raw inputs) in ``cfg.dtype``."""
        c = self.cfg
        d_in, nh, hd, ds = self.dims
        k = c.conv_kernel - 1
        return {"ssm": torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device),
                "conv_x": torch.zeros((batch, k, d_in), dtype=c.dtype, device=device),
                "conv_b": torch.zeros((batch, k, ds), dtype=c.dtype, device=device),
                "conv_c": torch.zeros((batch, k, ds), dtype=c.dtype, device=device)}

    def decode(self, params, u, cache, *, donate: bool = False):
        """Single-token recurrent step.  u: (B, 1, d_model).  Returns (out,
        new_cache); with ``donate`` the state and windows are written into
        ``cache`` in place and it is returned."""
        c = self.cfg
        d_in, nh, hd, ds = self.dims
        Bsz = u.shape[0]
        z, x_raw, B_raw, C_raw, dt = self._project(params, u)

        def conv_step(raw, window, w):
            win = torch.cat([window, raw], dim=1)                # (B, k, C)
            y = F.silu(torch.einsum("bkc,kc->bc", win, w.to(c.dtype)))
            return y[:, None, :], win[:, 1:, :]

        x1, new_cx = conv_step(x_raw, cache["conv_x"], params["conv"]["x"])
        B1, new_cb = conv_step(B_raw, cache["conv_b"], params["conv"]["b"])
        C1, new_cc = conv_step(C_raw, cache["conv_c"], params["conv"]["c"])

        x = x1.reshape(Bsz, nh, hd)
        A = -torch.exp(params["ssd"]["A_log"].float())
        dtv = F.softplus(dt[:, 0].float() + params["ssd"]["dt_bias"].float())   # (B,nh)
        from repro_torch.kernels.ssd_scan.ref import ssd_decode_ref
        y, state = ssd_decode_ref(cache["ssm"], x, dtv, A, B1[:, 0, :], C1[:, 0, :])
        y = y + x * params["ssd"]["D"].to(c.dtype)[None, :, None]
        y = y.reshape(Bsz, 1, d_in)
        y = nn.RMSNorm(d_in).apply(params["norm"], y) * F.silu(z)
        out = y @ params["out_proj"]["w"].to(c.dtype)
        new = {"ssm": state, "conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc}
        if donate:
            for key, leaf in new.items():
                cache[key].copy_(leaf)
            return out, cache
        return out, new


def _scan_on_shards(scan, x, dt, A, Bm, Cm, return_state):
    """``scan(x, dt, A, Bm, Cm)`` (the SSD kernel) -> y [, final state].
    Under a mesh it runs on the local shards: the time axis and head_dim
    enter whole (the scan runs along the one, the state contracts the
    other), batch stays sharded, and heads stay sharded with ``dt`` and
    ``A`` sharded alike (every head scans on its own; B and C are shared by
    the heads).  Plain tensors go straight in."""
    if not is_sharded(x):
        return scan(x, dt, A, Bm, Cm)
    from torch.distributed.tensor import Replicate, Shard
    x = whole_dims(x, 1, 3)
    mesh = x.device_mesh

    def pick(rule):
        return tuple(rule.get(p, Replicate()) for p in x.placements)

    batch, head = Shard(0), Shard(2)
    pl = {"x": pick({batch: batch, head: head}), "dt": pick({batch: batch, head: head}),
          "A": pick({head: Shard(0)}), "bc": pick({batch: batch})}
    args = (x.redistribute(mesh, pl["x"]), dt.redistribute(mesh, pl["dt"]),
            A.redistribute(mesh, pl["A"]), Bm.redistribute(mesh, pl["bc"]),
            Cm.redistribute(mesh, pl["bc"]))
    out = pl["x"]
    if return_state:
        out = (out, pick({batch: batch, head: Shard(1)}))
    return local_kernel(scan, out, *args)


def _tail_window(x, k: int):
    """Last k steps of (B, T, C), zero-padded on the left if T < k."""
    T = x.shape[1]
    if T >= k:
        return x[:, T - k:, :].clone()      # not a view that keeps x alive
    return F.pad(x, (0, 0, k - T, 0))
