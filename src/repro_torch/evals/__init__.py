"""The paper's metrics (a port of ``repro.evals``): the Fréchet distance
stand-in for FID, mode coverage, and k-means centroid matching."""
from repro_torch.evals.fd import (fd_score, frechet_distance, random_feature_fn,
                                  random_features)
from repro_torch.evals.kmeans import centroid_match_score, kmeans
from repro_torch.evals.modes import mode_stats, wasserstein_1d_proj

__all__ = [
    "centroid_match_score", "fd_score", "frechet_distance", "kmeans",
    "mode_stats", "random_feature_fn", "random_features", "wasserstein_1d_proj",
]
