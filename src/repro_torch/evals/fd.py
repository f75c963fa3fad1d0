"""Fréchet distance score (FID stand-in), a port of ``repro.evals.fd``.

No pretrained Inception-v3 is available offline, so the metric keeps the
Gaussian-Fréchet form over a *fixed* random two-layer ReLU projection,
drawn once per evaluation from a ``torch.Generator`` and identical for the
real and the generated batch.  The projection runs on the generator's
device (float32, TF32 off as everywhere in the port); the distance itself
in numpy float64, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def random_features(w1: torch.Tensor, w2: torch.Tensor):
    """The feature map ``x -> relu(flatten(x) @ w1) @ w2``, on w1's device."""

    def feats(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=w1.device)
        return torch.clamp(x.reshape(x.shape[0], -1) @ w1, min=0.0) @ w2

    return feats


def random_feature_fn(gen: torch.Generator, in_dim: int, feat_dim: int = 64,
                      hidden: int = 256):
    """A fixed random projection to ``feat_dim`` features, weights drawn
    from ``gen`` on its device: w1 (in_dim, hidden) and w2 (hidden,
    feat_dim), standard normal over the root of their fan-in."""
    dev = gen.device
    w1 = torch.randn((in_dim, hidden), generator=gen, device=dev) / math.sqrt(in_dim)
    w2 = torch.randn((hidden, feat_dim), generator=gen, device=dev) / math.sqrt(hidden)
    return random_features(w1, w2)


def _sqrtm_psd(mat):
    """Matrix square root of a symmetric PSD matrix via eigh."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def _host64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def frechet_distance(feats_real, feats_fake) -> float:
    """d^2 = ||mu_r - mu_f||^2 + Tr(S_r + S_f - 2 (S_r^1/2 S_f S_r^1/2)^1/2),
    in float64 on the host."""
    fr, ff = _host64(feats_real), _host64(feats_fake)
    mu_r, mu_f = fr.mean(0), ff.mean(0)
    cr = np.cov(fr, rowvar=False) + 1e-6 * np.eye(fr.shape[1])
    cf = np.cov(ff, rowvar=False) + 1e-6 * np.eye(ff.shape[1])
    sr = _sqrtm_psd(cr)
    mid = _sqrtm_psd(sr @ cf @ sr)
    d2 = float(np.sum((mu_r - mu_f) ** 2) + np.trace(cr + cf - 2 * mid))
    return max(d2, 0.0)


def fd_score(gen: torch.Generator, real, fake, *, feat_dim: int = 64) -> float:
    """End-to-end FD between two sample batches (any shape; flattened),
    through a projection drawn from ``gen``."""
    in_dim = math.prod(real.shape[1:])
    feats = random_feature_fn(gen, in_dim, feat_dim)
    return frechet_distance(feats(real), feats(fake))
