"""Byzantine attack simulation: the adversaries the robust aggregators are
tested against (a port of ``repro.privacy.attacks``).

:class:`WithByzantine` wraps any ``FedAvgSync``-family strategy: at sync
time the first ``num_byzantine`` agents of the flattened (P, A) grid ship
corrupted parameters instead of their honest ones (what a malicious agent
puts on the wire; its local training does not matter).  The wrapped
strategy then aggregates the poisoned fleet as it would the honest one.

Attacks:

  ``sign_flip``  ship -x
  ``scale``      ship scale·x (default x100, a magnitude outlier)
  ``nan``        ship NaN everywhere

Test and benchmark scaffolding, not a training feature: it is not in the
``--strategy`` registry.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_map

ATTACKS = ("sign_flip", "scale", "nan")


def corrupt(tree, *, attack: str, num_byzantine: int, scale: float = 100.0):
    """Corrupt the first ``num_byzantine`` agents' slices of every inexact
    agent-stacked (P, A, ...) leaf; integer leaves pass through."""
    if attack not in ATTACKS:
        raise ValueError(f"unknown attack {attack!r}; known: {list(ATTACKS)}")

    def poison(x):
        if not x.is_floating_point():
            return x
        P, A = x.shape[:2]
        flat = x.reshape((P * A,) + tuple(x.shape[2:]))
        if attack == "sign_flip":
            bad = -flat
        elif attack == "scale":
            bad = scale * flat
        else:
            bad = torch.full_like(flat, float("nan"))
        mask = (torch.arange(P * A, device=x.device) < num_byzantine).reshape(
            (P * A,) + (1,) * (flat.dim() - 1))
        return torch.where(mask, bad, flat).reshape(x.shape)

    return tree_map(poison, tree)


@dataclasses.dataclass(frozen=True)
class WithByzantine:
    """Strategy wrapper planting Byzantine agents at sync time.  Every hook
    is ``inner``'s; only the parameters the attackers ship are
    corrupted."""

    inner: Any
    attack: str = "sign_flip"
    num_byzantine: int = 1
    scale: float = 100.0

    @property
    def name(self):
        return f"{self.inner.name}+byz_{self.attack}x{self.num_byzantine}"

    @property
    def intra_interval(self):
        return self.inner.intra_interval

    @property
    def reads_round_on_host(self):
        return self.inner.reads_round_on_host

    def validate(self, cfg):
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r}; "
                             f"known: {list(ATTACKS)}")
        if not 0 <= self.num_byzantine <= cfg.num_agents:
            raise ValueError(
                f"num_byzantine must be in [0, {cfg.num_agents}], "
                f"got {self.num_byzantine}")
        self.inner.validate(cfg)

    def init_round_state(self, fed, state):
        return self.inner.init_round_state(fed, state)

    def grad_hook(self, fed, grad_disc, grad_gen, state):
        return self.inner.grad_hook(fed, grad_disc, grad_gen, state)

    def segment_sync(self, fed, state):
        return self.inner.segment_sync(fed, state)

    def round_sync(self, fed, state):
        poisoned = dict(state)
        poisoned["params"] = corrupt(state["params"], attack=self.attack,
                                     num_byzantine=self.num_byzantine,
                                     scale=self.scale)
        return self.inner.round_sync(fed, poisoned)

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        return self.inner.bytes_per_round(cfg, params, opt)
