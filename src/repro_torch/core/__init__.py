from repro_torch.core.fedgan import FedGAN, FedGANConfig, GANTask, uniform_weights
from repro_torch.core.strategies import (STRATEGIES, FedAvgSync, LocalOnly,
                                         PartialSharing, SyncStrategy,
                                         get_strategy)
from repro_torch.core.tasks import ACGAN, CONDITIONAL, NS, LossSpec, make_gan_task

__all__ = ["FedGAN", "FedGANConfig", "GANTask", "uniform_weights",
           "SyncStrategy", "LocalOnly", "FedAvgSync", "PartialSharing",
           "STRATEGIES", "get_strategy", "LossSpec", "NS",
           "CONDITIONAL", "ACGAN", "make_gan_task"]
