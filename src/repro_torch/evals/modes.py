"""Mode-coverage metrics for the mixed-Gaussian experiment (Fig. 6), a copy
of ``repro.evals.modes`` (numpy; tensors are brought to the host)."""
from __future__ import annotations

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mode_stats(samples, modes, *, radius: float = 0.3):
    """Returns (modes_covered, high_quality_fraction, per-mode counts).

    A sample is 'high quality' if within ``radius`` of its nearest mode; a
    mode is covered if it captures >= 1% of the samples."""
    s = _host(samples)
    m = _host(modes)
    d = np.linalg.norm(s[:, None, :] - m[None, :, :], axis=-1)
    nearest = d.argmin(axis=1)
    near_dist = d.min(axis=1)
    hq = near_dist < radius
    counts = np.bincount(nearest[hq], minlength=m.shape[0])
    covered = int((counts >= max(1, int(0.01 * len(s)))).sum())
    return covered, float(hq.mean()), counts


def wasserstein_1d_proj(a, b, n_proj: int = 32, seed: int = 0) -> float:
    """Sliced 1-D Wasserstein distance (cheap distributional distance for the
    Swiss-roll comparison)."""
    rng = np.random.RandomState(seed)
    a = _host(a)
    b = _host(b)
    total = 0.0
    for _ in range(n_proj):
        v = rng.randn(a.shape[1])
        v /= np.linalg.norm(v) + 1e-12
        pa = np.sort(a @ v)
        pb = np.sort(b @ v)
        n = min(len(pa), len(pb))
        ia = np.linspace(0, len(pa) - 1, n).astype(int)
        ib = np.linspace(0, len(pb) - 1, n).astype(int)
        total += float(np.abs(pa[ia] - pb[ib]).mean())
    return total / n_proj
