"""Per-round participation sampling (a port of
``repro.core.participation``).

:class:`ParticipationSchedule` is the single source of cohort draws: of
``n`` agents, the ``m`` with the largest scores take part in round ``r``,
and the scores are a pure function of ``(seed, r)``, so a resumed run
replays the same cohorts.  The scores are the reference's own bits:
``uniform(fold_in(key(seed), r), (n,))`` of ``jax.random``, computed on
the host by ``repro_torch.prng``.  With ``weights`` the draw is
probability-proportional-to-weight through Efraimidis–Spirakis keys (the
top m of ``log(u_i) / w_i``, in float32).

Everything here runs on the host.  ``SubsampledFedAvg`` sends the (P, A)
mask to the device as a small tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import prng

# separates the arrival-time stream from the cohort-score stream, as in
# the reference: cohort scores fold (seed, round), arrival draws fold
# (seed, dispatch, _ARRIVAL_FOLD + salt)
_ARRIVAL_FOLD = 1 << 20


@dataclasses.dataclass(frozen=True)
class ParticipationSchedule:
    """Seeded, resumable per-round cohort sampler.  ``weights`` (one per
    agent, all positive) biases the draw toward larger weights."""

    seed: int = 0
    weights: tuple | None = None

    def validate(self, n_total: int | None = None) -> None:
        if self.weights is not None:
            w = np.asarray(self.weights, np.float64)
            if w.ndim != 1 or w.size == 0:
                raise ValueError(f"weights must be a flat non-empty tuple, "
                                 f"got shape {w.shape}")
            if not np.isfinite(w).all() or (w <= 0).any():
                raise ValueError("participation weights must be finite and "
                                 "strictly positive")
            if n_total is not None and w.size != n_total:
                raise ValueError(f"got {w.size} participation weights for "
                                 f"{n_total} clients")

    def _scores(self, round_idx: int, n: int) -> np.ndarray:
        """Per-agent priority scores of a round (float32); the ``m``
        largest win.  Shared by :meth:`cohort` and :meth:`mask`."""
        u = prng.uniform(prng.fold_in(prng.key(self.seed), int(round_idx)), n)
        if self.weights is None:
            return u
        w = np.asarray(self.weights, np.float32)
        with np.errstate(divide="ignore"):
            return np.log(u) / w

    def cohort(self, round_idx: int, n_total: int, m: int) -> np.ndarray:
        """The ``m`` participating agent ids of ``round_idx``, sorted.
        ``m == n_total`` is every agent, in id order, with no draw."""
        self.validate(n_total)
        if not 1 <= m <= n_total:
            raise ValueError(f"cohort size m={m} must be in [1, {n_total}]")
        if m == n_total:
            return np.arange(n_total)
        scores = self._scores(round_idx, n_total)
        top = np.argpartition(scores, n_total - m)[n_total - m:]
        return np.sort(top)

    def arrival_uniforms(self, index: int, n: int, salt: int = 0) -> np.ndarray:
        """Per-agent float32 uniforms in [0, 1) for arrival-time sampling,
        a pure function of ``(seed, index, salt)``, on a stream disjoint
        from the cohort scores."""
        k = prng.fold_in(prng.key(self.seed), int(index))
        return prng.uniform(prng.fold_in(k, _ARRIVAL_FOLD + int(salt)), n)

    def mask(self, round_idx: int, grid: tuple, m: int) -> np.ndarray:
        """(P, A) bool participation mask of the dense layout (agent id =
        flattened (p, a) index), from the same scores as :meth:`cohort`."""
        P, A = grid
        scores = self._scores(round_idx, P * A)
        kth = np.sort(scores)[-m]
        return (scores >= kth).reshape(P, A)
