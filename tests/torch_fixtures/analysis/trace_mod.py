"""Planted round-level violations (fixture for the trace auditor tests in
tests/test_torch_analysis.py).

Each violation has a waived twin carrying the ``analysis: allow`` marker;
the test finds each planted line by its text.  The loop-body ones are
strategies whose gradient hook (run inside every local step) misbehaves."""
import torch

from repro_torch import prng
from repro_torch.core.strategies import FedAvgSync


class ItemInLoop(FedAvgSync):
    def grad_hook(self, fed, gd, gg, state):
        scale = gg["theta"].abs().sum().item()          # planted: host wait in the loop
        del scale
        return gd, gg


class ItemInLoopWaived(FedAvgSync):
    def grad_hook(self, fed, gd, gg, state):
        # deliberate per-step debug read (fixture)
        scale = gg["theta"].abs().sum().item()  # analysis: allow(host-callback-in-scan)
        del scale
        return gd, gg


class RawKeyInLoop(FedAvgSync):
    def grad_hook(self, fed, gd, gg, state):
        gen = torch.Generator().manual_seed(0)          # planted: raw seed in the loop
        return gd, {k: v + 0 * torch.rand((), generator=gen) for k, v in gg.items()}


class RawKeyInLoopWaived(FedAvgSync):
    def grad_hook(self, fed, gd, gg, state):
        gen = torch.Generator().manual_seed(0)  # analysis: allow(raw-fold-in)
        return gd, {k: v + 0 * torch.rand((), generator=gen) for k, v in gg.items()}


def pad_reuse(key):
    a = prng.fold_in_t(key, 7)
    b = prng.fold_in_t(key, 7)                          # planted: pad reuse
    return a, b


def pad_reuse_waived(key):
    a = prng.fold_in_t(key, 7)
    b = prng.fold_in_t(key, 7)  # analysis: allow(pad-reuse)
    return a, b
