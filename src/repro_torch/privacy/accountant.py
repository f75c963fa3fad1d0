"""RDP (moments) accountant for the sampled Gaussian mechanism (the port's
own copy of ``repro.privacy.accountant``, the same floats).

One DP-SGD step on one agent is the sampled Gaussian mechanism: each
example participates with probability q (the sampling rate), the clipped
per-example gradients are summed, and Gaussian noise with standard
deviation sigma·C is added (C the clip norm).  Its Renyi differential
privacy at order alpha composes additively over steps, and converts to an
(epsilon, delta) guarantee via

    epsilon(delta) = min_alpha  T·rdp(alpha) + log(1/delta) / (alpha - 1)

(the standard RDP->DP conversion of Mironov 2017; we deliberately use the
basic conversion so the closed-form tests have an analytic target).

``rdp_order`` implements the two regimes exactly:

  * q = 1 (every example every step — the deterministic Gaussian
    mechanism): rdp(alpha) = alpha / (2 sigma^2) for any real alpha > 1.
    The continuous minimiser alpha* = 1 + sigma·sqrt(2·log(1/delta)/T)
    gives the analytic bound

        epsilon = T / (2 sigma^2) + sqrt(2·T·log(1/delta)) / sigma

    which ``epsilon`` matches to float64 precision (the closed-form test
    fixture of tests/test_privacy.py).
  * q < 1, integer alpha (Mironov-Talwar-Zhang 2019, Poisson subsampling):

        rdp(alpha) = log( sum_{k=0..alpha} C(alpha,k) (1-q)^(alpha-k) q^k
                          · exp(k(k-1) / (2 sigma^2)) ) / (alpha - 1)

    evaluated in log space (float64) so large orders do not overflow.

Everything here is host-side closed-form math on static config — the
device-side cost of DP-SGD is in ``repro_torch.privacy.dpsgd``; the
accountant is what ``RoundDriver`` surfaces as ``dp_epsilon`` next to the round
metrics and in the sweep JSONL histories.
"""
from __future__ import annotations

import math

DEFAULT_ORDERS = tuple(range(2, 129))


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def _logsumexp(vals) -> float:
    m = max(vals)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(v - m) for v in vals))


def rdp_order(alpha: float, *, noise_multiplier: float,
              sample_rate: float = 1.0) -> float:
    """Per-step RDP of the sampled Gaussian mechanism at order ``alpha``.

    ``alpha`` may be any real > 1 when ``sample_rate`` is 1; subsampled
    rates require integer orders (the binomial expansion above).
    """
    sigma, q = float(noise_multiplier), float(sample_rate)
    if sigma <= 0:
        return math.inf
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sample_rate must be in (0, 1], got {q}")
    if alpha <= 1:
        raise ValueError(f"RDP order must exceed 1, got {alpha}")
    if q == 1.0:
        return alpha / (2.0 * sigma * sigma)
    if int(alpha) != alpha:
        raise ValueError(
            f"subsampled RDP (q={q}) needs integer orders, got {alpha}")
    a = int(alpha)
    terms = [
        _log_comb(a, k) + (a - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + k * (k - 1) / (2.0 * sigma * sigma)
        for k in range(a + 1)
    ]
    return _logsumexp(terms) / (a - 1)


def epsilon(*, noise_multiplier: float, steps: int, sample_rate: float = 1.0,
            delta: float = 1e-5, orders=None) -> float:
    """(epsilon, delta)-DP spent after ``steps`` compositions.

    Minimises the RDP->DP conversion over ``orders`` (default: integer
    2..128, plus — when q = 1 — the continuous optimum, so the q = 1
    answer IS the analytic Gaussian-mechanism bound, not a grid
    approximation)."""
    if steps <= 0 or noise_multiplier <= 0:
        return math.inf if noise_multiplier <= 0 and steps > 0 else 0.0
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    sigma, q, T = float(noise_multiplier), float(sample_rate), int(steps)
    L = math.log(1.0 / delta)
    cands = list(orders if orders is not None else DEFAULT_ORDERS)
    if q == 1.0:
        # continuous minimiser of T·a/(2s^2) + L/(a-1)
        cands.append(1.0 + sigma * math.sqrt(2.0 * L / T))
    best = math.inf
    for a in cands:
        if a <= 1:
            continue
        eps = T * rdp_order(a, noise_multiplier=sigma, sample_rate=q) \
            + L / (a - 1)
        best = min(best, eps)
    return best
