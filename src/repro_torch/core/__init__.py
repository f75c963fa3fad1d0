from repro_torch.core.fedgan import FedGAN, FedGANConfig, GANTask, uniform_weights
from repro_torch.core.strategies import FedAvgSync, LocalOnly, SyncStrategy
from repro_torch.core.tasks import ACGAN, CONDITIONAL, NS, LossSpec, make_gan_task

__all__ = ["FedGAN", "FedGANConfig", "GANTask", "uniform_weights",
           "SyncStrategy", "LocalOnly", "FedAvgSync", "LossSpec", "NS",
           "CONDITIONAL", "ACGAN", "make_gan_task"]
