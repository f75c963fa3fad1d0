"""Learning-rate schedules (a port of ``repro.optim.schedules``).

The paper's convergence theory needs (A2): sum a(n) = inf, sum a(n)^2 <
inf, met by power decays a(n) = a0 / (1 + n/tau)^p with p in (1/2, 1];
two-time-scale updates (Appendix A) also need (A6): b(n) = o(a(n)).  A
schedule maps the float32 step tensor to a float32 learning-rate tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr


def constant(lr: float) -> Schedule:
    # full_like fills on n's device: a host scalar copied to the card would
    # make the host wait for the stream on every step
    return lambda n: torch.full_like(n, lr, dtype=torch.float32)


def power_decay(a0: float, tau: float = 100.0, p: float = 0.75) -> Schedule:
    """a(n) = a0 / (1 + n/tau)^p.  (A2) holds iff 1/2 < p <= 1."""
    if not (0.5 < p <= 1.0):
        raise ValueError(f"power_decay exponent p={p} violates (A2); need 1/2 < p <= 1")

    def sched(n):
        return torch.full_like(n, a0, dtype=torch.float32) / (1.0 + n / tau) ** p

    return sched


@dataclasses.dataclass(frozen=True)
class TimeScales:
    """The (a(n), b(n)) pair for discriminator / generator updates."""

    a: Schedule  # discriminator lr a(n)
    b: Schedule  # generator lr b(n)
    equal: bool  # True -> the single time-scale analysis (Theorem 1) applies


def equal_timescale(sched: Schedule) -> TimeScales:
    return TimeScales(a=sched, b=sched, equal=True)


def constant_ttur(a0: float, b0: float) -> TimeScales:
    """Constant two-time-scale rates (the paper's Table 2 uses lr_D = 2 lr_G)."""
    return TimeScales(a=constant(a0), b=constant(b0), equal=a0 == b0)
