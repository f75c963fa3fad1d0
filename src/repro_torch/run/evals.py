"""Eval harness for the round driver (a port of ``repro.run.evals``): the
port's ``evals`` as periodic hooks on the intermediary's averaged
parameters.

An :class:`EvalSuite` describes how to score one experiment: the pooled
real samples, how to draw generated samples from the averaged generator,
and which metrics apply (the FD stand-in always; mode coverage when the
reference modes are known; centroid matching for the time series).
:func:`evaluate` runs it once; :func:`eval_hook` packages it for
``RoundDriver(eval_hooks=...)``.

Evaluation always scores the *intermediary's* parameters (the weighted
average of eq. (2), no broadcast), the object the paper's figures track,
never one agent's copy.  Generated samples and the FD projection are
drawn on the state's device from a ``torch.Generator`` seeded from
``(seed, round)``: the same distributions as the reference, other bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.evals import centroid_match_score, fd_score, mode_stats


@dataclasses.dataclass(frozen=True)
class EvalSuite:
    """One experiment's evaluation recipe.

    ``sample_fake(gen_params, generator, n)`` draws n samples from the
    averaged generator; ``real`` holds pooled (cross-agent) real samples of
    the same shape.  ``modes`` enables mode-coverage stats;
    ``kind="timeseries"`` additionally reports the centroid-matching RMSE
    of Fig. 3/4.
    """

    real: Any
    sample_fake: Callable[[Any, torch.Generator, int], Any]
    modes: Any = None
    kind: str = "fd"           # "fd" | "timeseries"
    feat_dim: int = 64
    mode_radius: float = 0.5


def _generator(seed_words, device) -> torch.Generator:
    """A generator on ``device`` seeded from numpy's ``SeedSequence`` of
    ``seed_words`` (the round index folded in, as the reference folds it
    into its key)."""
    s = np.random.SeedSequence(list(seed_words)).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def evaluate(suite: EvalSuite, fed, state, gen: torch.Generator, *,
             n: int = 1024) -> dict:
    """Score the intermediary's generator: always the FD stand-in (the
    fixed-random-feature Fréchet distance of ``repro_torch.evals.fd``),
    plus the suite's extra metrics.  ``gen`` draws the generated samples
    and then the projection.  Returns a flat dict of floats."""
    params = fed.averaged_params(state)["gen"]
    n = min(n, int(suite.real.shape[0]))
    with torch.no_grad():
        fake = suite.sample_fake(params, gen, n)
    real = suite.real[:n]
    if not bool(torch.isfinite(fake).all()):
        return {"fd": float("inf"), "nonfinite": 1.0}
    out = {"fd": fd_score(gen, real, fake, feat_dim=suite.feat_dim)}
    if suite.modes is not None:
        covered, hq, _ = mode_stats(fake.reshape(n, -1), suite.modes,
                                    radius=suite.mode_radius)
        out["modes_covered"] = float(covered)
        out["high_quality_frac"] = hq
    if suite.kind == "timeseries":
        cm = centroid_match_score(real.reshape(n, -1), fake.reshape(n, -1))
        out["centroid_rmse"] = cm["matched_rmse"]
        out["centroid_rmse_random"] = cm["random_rmse"]
    return out


def eval_hook(suite: EvalSuite, *, seed: int = 0, n: int = 1024) -> Callable:
    """An ``eval_hooks`` entry for the driver: ``fn(fed, state, round_idx)
    -> dict``.  The generator is seeded from ``(seed, round_idx)``, so
    repeated evaluations are comparable but not identical draws."""

    def hook(fed, state, round_idx: int) -> dict:
        gen = _generator((seed, round_idx), state["step"].device)
        return evaluate(suite, fed, state, gen, n=n)

    return hook


def final_fd(suite: EvalSuite, fed, state, *, seed: int = 0,
             n: int = 2048) -> dict:
    """End-of-run evaluation at a larger sample budget (sweep summaries)."""
    return evaluate(suite, fed, state, _generator((seed,), state["step"].device), n=n)

