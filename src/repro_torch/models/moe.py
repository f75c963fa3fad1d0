"""Mixture-of-Experts FFN with top-k routing and capacity-based einsum
dispatch (a port of ``repro.models.moe``): tokens are routed within groups
of ``moe_group_size``, every expert takes at most ``capacity`` tokens of a
group, and the dispatch and combine are one-hot einsums in ``cfg.dtype``.

Expert weights are stacked (E, d_model, d_ff), so the FedGAN sync averages
them like any other leaf.  A Switch-style load-balance auxiliary loss is
returned beside the output.  The reference's sharding constraints stand at
the same places (the identity without a mesh).

Two details keep the routing the reference's, token for token:

* ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order for ties.  The top k are
  taken from a stable descending sort instead.
* ``F.one_hot`` cannot run under ``torch.func.vmap`` of a gradient (the
  local step of every agent), so every one-hot here is a comparison
  against an ``arange``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.dist.sharding import batch_spec, shard
from repro_torch.models.config import ArchConfig


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


@dataclasses.dataclass(frozen=True)
class MoE(nn.Module):
    cfg: ArchConfig

    def init(self, gen):
        c = self.cfg
        E, d, f = c.num_experts, c.d_model, c.d_ff
        lim = math.sqrt(6.0 / (d + f))

        def uniform(shape):
            return torch.empty(shape, device=gen.device).uniform_(
                -lim, lim, generator=gen).to(c.param_dtype)

        return {
            "router": {"w": (0.02 * torch.randn((d, E), generator=gen, device=gen.device)
                             ).to(c.param_dtype)},
            "experts": {"w_gate": uniform((E, d, f)), "w_up": uniform((E, d, f)),
                        "w_down": uniform((E, f, d))},
        }

    def capacity(self, group: int) -> int:
        """Slots per expert in a group of ``group`` tokens."""
        c = self.cfg
        return int(max(1, (c.experts_per_token * group * c.capacity_factor)
                       // c.num_experts))

    def route(self, params, x):
        """The routing of x (B, T, d): ``(probs (n, G, E) float32, gate_vals
        (n, G, k) float32 before the capacity drop, gate_idx (n, G, k) int64,
        pos (n, G, k) int64, keep (n, G, k) bool)`` with n·G = B·T."""
        c = self.cfg
        E, k = c.num_experts, c.experts_per_token
        B, T, d = x.shape
        G = max(min(c.moe_group_size, T), 1)
        xt = x.reshape((B * T) // G, G, d)
        logits = (xt @ params["router"]["w"].to(c.dtype)).float()         # (n, G, E)
        probs = torch.softmax(logits, dim=-1)
        # top-k, ties to the lower index as jax.lax.top_k
        srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, gate_idx = srt[..., :k], order[..., :k]
        gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)
        # position of each (token, choice) in its expert's buffer: a cumsum
        # over the group's (G·k) routing order, token-major then choice
        onehot = _one_hot(gate_idx, E, torch.float32)                      # (n, G, k, E)
        flat = onehot.reshape(onehot.shape[0], G * k, E)
        pos = torch.sum((torch.cumsum(flat, dim=1) - flat) * flat, dim=-1)
        pos = pos.reshape(gate_idx.shape).long()
        return probs, gate_vals, gate_idx, pos, pos < self.capacity(G)

    def apply(self, params, x):
        """x: (B, T, d) -> (y, aux_loss)."""
        c = self.cfg
        E = c.num_experts
        B, T, d = x.shape
        G = max(min(c.moe_group_size, T), 1)
        xt = x.reshape((B * T) // G, G, d)
        probs, gate_vals, gate_idx, pos, keep = self.route(params, x)

        # Switch-style load-balance loss over the group axis
        onehot = _one_hot(gate_idx, E, torch.float32)                      # (n, G, k, E)
        me = torch.mean(probs, dim=1)                                      # (n, E)
        ce = torch.mean(torch.sum(onehot, dim=2), dim=1)                   # (n, E)
        aux = E * torch.mean(torch.sum(me * ce, dim=-1))

        # capacity-based dispatch within each group
        cap = self.capacity(G)
        gate_vals = gate_vals * keep.to(gate_vals.dtype)
        pos_oh = _one_hot(torch.where(keep, pos, cap), cap, c.dtype)       # (n, G, k, cap)
        oh = onehot.to(c.dtype)
        disp = torch.einsum("ngke,ngkc->ngec", oh, pos_oh)
        comb = torch.einsum("ngk,ngke,ngkc->ngec", gate_vals.to(c.dtype), oh, pos_oh)
        disp = shard(disp, *batch_spec(None, None, None))
        expert_in = torch.einsum("ngec,ngd->necd", disp, xt)               # (n, E, cap, d)
        expert_in = shard(expert_in, *batch_spec(None, None, None))

        wg = params["experts"]["w_gate"].to(c.dtype)
        wu = params["experts"]["w_up"].to(c.dtype)
        wd = params["experts"]["w_down"].to(c.dtype)
        h = F.silu(torch.einsum("necd,edf->necf", expert_in, wg))
        h = h * torch.einsum("necd,edf->necf", expert_in, wu)
        h = shard(h, *batch_spec(None, None, "model"))
        expert_out = torch.einsum("necf,efd->necd", h, wd)                 # (n, E, cap, d)
        y = torch.einsum("ngec,necd->ngd", comb, expert_out)
        return shard(y.reshape(B, T, d), *batch_spec(None, None)), aux.float()
