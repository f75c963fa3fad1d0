"""The round driver on the device-resident path (a port of
``repro.run.driver.RoundDriver``).

A Python loop over rounds: each round draws its K minibatches on the
device (``FedGAN.round_from_data``) from its own seeded generator.  No
round waits on the device for its metrics: they stay on the device and are
fetched at ``log_every`` boundaries, and once, all together, at the end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.data.federated import round_key_schedule
from repro_torch.tree import tree_map


@dataclasses.dataclass
class RunResult:
    """``history`` is one dict of float metrics per round, ``evals`` one
    dict per eval point, ``timings`` the wall-clock accounting: total
    seconds, steps per second, and the round gap, the host work between
    round dispatches per round (an upper bound on device idle time)."""

    fed: Any
    state: Any
    history: list
    evals: list
    timings: dict


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RoundDriver:
    """Drives ``n_rounds`` FedGAN rounds over a ``DeviceFederatedData``.
    ``eval_hooks`` entries are callables ``(fed, state, round_idx) ->
    dict``, run every ``eval_every`` rounds on the state right after the
    round's sync.  With ``ckpt_dir`` and ``ckpt_every`` the state after
    round r is saved at step (r + 1)·K whenever ``(r + 1) % ckpt_every ==
    0``, with metadata ``{"round": r, "K": K}``."""

    fed: Any
    data: Any
    n_rounds: int
    log_every: int = 1
    eval_every: int = 0
    eval_hooks: Sequence[Callable] = ()
    ckpt_every: int = 0
    ckpt_dir: str = ""
    verbose: bool = True

    def __post_init__(self):
        if getattr(self.data, "kind", "") != "device":
            raise ValueError("the port drives device-resident data only "
                             "(DeviceFederatedData)")
        if self.eval_every and not self.eval_hooks:
            raise ValueError("eval_every is set but eval_hooks is empty")

    def run(self, seed: int, state=None) -> RunResult:
        """Execute the round loop.  ``seed`` seeds the per-round generators
        (``round_key_schedule``); ``state`` defaults to a fresh init from a
        ``torch.Generator`` seeded with ``seed``."""
        dev = self.data.device
        if state is None:
            state = self.fed.init_state(torch.Generator().manual_seed(seed),
                                        device=dev)
        evals, raw = [], []
        gap = 0.0
        t0 = time.perf_counter()
        t_host = t0
        gens = round_key_schedule(seed, self.n_rounds, dev)
        for r, gen in enumerate(gens):
            gap += time.perf_counter() - t_host
            state, metrics = self.fed.round_from_data(state, self.data, gen)
            t_host = time.perf_counter()
            raw.append(tree_map(torch.mean, metrics))   # stays on the device
            self._boundaries(state, r, raw[r], evals)
        gap += time.perf_counter() - t_host
        _synchronize(dev)
        total = time.perf_counter() - t0
        keys = sorted(raw[0]) if raw else []
        # one fetch for the whole run, after every round was dispatched
        table = torch.stack([torch.stack([m[k] for k in keys]) for m in raw]).tolist() \
            if raw else []
        history = [dict(zip(keys, row)) for row in table]
        K = self.fed.cfg.sync_interval
        timings = {
            "total_s": total,
            "steps_per_s": self.n_rounds * K / max(total, 1e-9),
            "round_gap_s": gap / max(self.n_rounds, 1),
            "data_kind": self.data.kind,
        }
        return RunResult(self.fed, state, history, evals, timings)

    def _boundaries(self, state, r, metrics, evals):
        """Per-round host work: logging (the only mid-run metric fetch),
        the periodic eval hooks and the periodic checkpoints."""
        K = self.fed.cfg.sync_interval
        last = r == self.n_rounds - 1
        if self.log_every and (r % self.log_every == 0 or last):
            m = {k: float(v) for k, v in metrics.items()}
            if self.verbose:
                print(f"round {r:5d}/{self.n_rounds} step {(r + 1) * K:6d} "
                      f"d_loss={m['d_loss']:.4f} g_loss={m['g_loss']:.4f}",
                      flush=True)
        if self.eval_every and ((r + 1) % self.eval_every == 0 or last):
            scores = {}
            for hook in self.eval_hooks:
                scores.update(hook(self.fed, state, r))
            evals.append({"round": r, "step": (r + 1) * K, **scores})
        if self.ckpt_dir and self.ckpt_every and (r + 1) % self.ckpt_every == 0:
            save_checkpoint(self.ckpt_dir, state, step=(r + 1) * K,
                            metadata={"round": r, "K": K})


def train(fed, data, n_rounds: int, seed: int, **kwargs) -> RunResult:
    """One-call convenience over :class:`RoundDriver`."""
    return RoundDriver(fed, data, n_rounds, **kwargs).run(seed)
