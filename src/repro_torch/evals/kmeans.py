"""k-means clustering + centroid-matching score for the time-series
experiments (paper Fig. 3/4: compare the top-9 cluster centroids of real
and generated profiles, quantified by an optimal assignment between the
two centroid sets).  A copy of ``repro.evals.kmeans`` (numpy and scipy;
tensors are brought to the host)."""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def _kmeanspp_init(x, k: int, rng):
    """k-means++ seeding (Arthur & Vassilvitskii): each next center is
    drawn proportional to squared distance from the chosen set."""
    cent = np.empty((k, x.shape[1]))
    cent[0] = x[rng.randint(len(x))]
    d2 = ((x - cent[0]) ** 2).sum(-1)
    for j in range(1, k):
        total = d2.sum()
        if total <= 0:
            cent[j:] = x[rng.randint(len(x), size=k - j)]
            break
        cent[j] = x[rng.choice(len(x), p=d2 / total)]
        d2 = np.minimum(d2, ((x - cent[j]) ** 2).sum(-1))
    return cent


def kmeans(x, k: int, *, iters: int = 50, seed: int = 0):
    """Lloyd's algorithm with k-means++ seeding.  Returns (centroids (k,d)
    sorted by cluster size desc, assignments, sizes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    rng = np.random.RandomState(seed)
    cent = _kmeanspp_init(x, k, rng)
    for _ in range(iters):
        d = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            pts = x[assign == j]
            if len(pts):
                cent[j] = pts.mean(0)
    d = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
    assign = d.argmin(1)
    sizes = np.bincount(assign, minlength=k)
    order = np.argsort(-sizes)
    remap = np.empty(k, int)
    remap[order] = np.arange(k)
    return cent[order], remap[assign], sizes[order]


def centroid_match_score(real, fake, *, k: int = 9, top: int = 9,
                         seed: int = 0) -> dict:
    """Cluster real and generated profiles separately, optimally match the
    top-``top`` centroids, and report the mean matched-centroid RMSE plus a
    baseline (RMSE against shuffled matching) for scale."""
    cr, _, _ = kmeans(real, k, seed=seed)
    cf, _, _ = kmeans(fake, k, seed=seed + 1)
    cr, cf = cr[:top], cf[:top]
    cost = np.sqrt(((cr[:, None, :] - cf[None]) ** 2).mean(-1))
    ri, ci = linear_sum_assignment(cost)
    matched = float(cost[ri, ci].mean())
    baseline = float(cost.mean())
    return {"matched_rmse": matched, "random_rmse": baseline,
            "real_centroids": cr, "fake_centroids": cf[ci]}
