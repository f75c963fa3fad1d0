from repro_torch.core.convergence import (ConstantEstimates, estimate_constants,
                                          measure_drift, r1_bound, r2_bound, tree_diff_norm,
                                          tree_norm)
from repro_torch.core.fedgan import (FedGAN, FedGANConfig, GANTask, dataset_weights,
                                     uniform_weights)
from repro_torch.core.participation import ParticipationSchedule
from repro_torch.core.strategies import (STRATEGIES, AdaptiveK, CoordinateMedianSync,
                                         FedAvgSync, Hierarchical, LocalOnly,
                                         PartialSharing, PerStepGradAvg, SubsampledFedAvg,
                                         SyncStrategy, TrimmedMeanSync, check_async_mergeable,
                                         get_strategy,
                                         strategy_from_mode)
from repro_torch.core.tasks import ACGAN, CONDITIONAL, NS, LossSpec, make_gan_task

__all__ = ["FedGAN", "FedGANConfig", "GANTask", "dataset_weights", "uniform_weights",
           "ParticipationSchedule", "SyncStrategy", "LocalOnly", "FedAvgSync",
           "PartialSharing", "PerStepGradAvg", "Hierarchical", "AdaptiveK",
           "SubsampledFedAvg", "TrimmedMeanSync", "CoordinateMedianSync", "STRATEGIES", "check_async_mergeable", "get_strategy", "strategy_from_mode",
           "LossSpec", "NS", "CONDITIONAL", "ACGAN", "make_gan_task", "ConstantEstimates",
           "estimate_constants", "measure_drift", "r1_bound", "r2_bound", "tree_norm",
           "tree_diff_norm"]
