"""Optimizers as pure transforms of parameter dicts.

    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state, lr)

A port of ``repro.optim.optimizer``: the same state keys (``count``,
``mu``, ``nu``, ``velocity``), the same defaults and the same order of
operations, so one agent's update computes what the JAX update computes.
``lr`` is passed per call so the FedGAN driver can feed the a(n), b(n)
schedules.  ``update`` returns new tensors and never writes its inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    def init(self, params):  # pragma: no cover - abstract
        raise NotImplementedError

    def update(self, params, grads, state, lr):  # pragma: no cover
        raise NotImplementedError


def _count(params):
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclasses.dataclass(frozen=True)
class SGD(Optimizer):
    """Plain SGD, optionally with heavy-ball momentum."""

    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return {"count": _count(params)}
        return {"count": _count(params),
                "velocity": tree_map(torch.zeros_like, params)}

    def update(self, params, grads, state, lr):
        if self.momentum == 0.0:
            new_params = tree_map(lambda p, g: p - lr * g, params, grads)
            return new_params, {"count": state["count"] + 1}
        vel = tree_map(lambda v, g: self.momentum * v + g, state["velocity"], grads)
        new_params = tree_map(lambda p, v: p - lr * v, params, vel)
        return new_params, {"count": state["count"] + 1, "velocity": vel}


@dataclasses.dataclass(frozen=True)
class Adam(Optimizer):
    """Adam; the paper's image experiments use Adam(b1=0.5, b2=0.999)."""

    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        return {"count": _count(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, params, grads, state, lr):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                      state["mu"], grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * torch.square(g),
                      state["nu"], grads)
        c = count.to(torch.float32)
        bc1 = 1.0 - self.b1 ** c
        bc2 = 1.0 - self.b2 ** c

        def step(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            return p - lr * mhat / (torch.sqrt(vhat) + self.eps)

        new_params = tree_map(step, params, mu, nu)
        return new_params, {"count": count, "mu": mu, "nu": nu}


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    """Adam with decoupled weight decay."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        return Adam(self.b1, self.b2, self.eps).init(params)

    def update(self, params, grads, state, lr):
        inner = Adam(self.b1, self.b2, self.eps)
        new_params, new_state = inner.update(params, grads, state, lr)
        if self.weight_decay:
            new_params = tree_map(
                lambda np_, p: np_ - lr * self.weight_decay * p, new_params, params)
        return new_params, new_state


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``.  An
    all-zero tree passes through with scale 1.0 instead of dividing by a
    zero norm.  A gradient taken through the clip at a zero norm is NaN,
    as in the reference: the norm's square root has no derivative at 0."""
    norm = global_norm(grads)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    # a tensor over a tensor: a Python number over a tensor multiplies by
    # the reciprocal, two roundings where the reference divides once
    scale = torch.where(norm > 0, torch.clamp(torch.full_like(safe, max_norm) / safe, max=1.0),
                        torch.ones_like(norm))
    return tree_map(lambda g: g * scale, grads), norm
