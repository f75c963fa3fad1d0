"""The paper's own experiment configurations (§4 + Appendices C/D/E), a
port of ``repro.configs.paper_gans``.

Each entry bundles the FedGAN hyperparameters (B, K, optimizers, learning
rates) from the paper's tables; ``repro_torch.launch.train.experiment_spec``
adds the nets, the non-iid split and the synthetic stand-in data.
"""
from __future__ import annotations

import dataclasses

from repro_torch.optim import (SGD, Adam, TimeScales, constant, constant_ttur,
                               equal_timescale, power_decay)


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    name: str
    num_agents: int
    sync_intervals: tuple         # K values swept in the paper
    default_K: int
    batch_size: int
    iterations: int
    opt: str                      # "sgd" | "adam"
    lr_d: float
    lr_g: float
    notes: str = ""


# §C / Fig 5: 2D system, B=5 agents on segments of U[-1,1]
TOY_2D = PaperExperiment(
    name="toy_2d", num_agents=5, sync_intervals=(1, 5, 20, 50), default_K=5,
    batch_size=64, iterations=4000, opt="sgd", lr_d=0.1, lr_g=0.1,
    notes="converges to (theta, psi) = (1, 0); robust to K")

# §C / Fig 6: mixed Gaussian, B=4 agents x 2 modes, K=5
MIXED_GAUSSIAN = PaperExperiment(
    name="mixed_gaussian", num_agents=4, sync_intervals=(5,), default_K=5,
    batch_size=128, iterations=15000, opt="adam", lr_d=2e-4, lr_g=2e-4)

# §C / Fig 7: Swiss roll, B=4 agents on arc segments, K=5
SWISS_ROLL = PaperExperiment(
    name="swiss_roll", num_agents=4, sync_intervals=(5,), default_K=5,
    batch_size=128, iterations=27000, opt="adam", lr_d=2e-4, lr_g=2e-4)

# §4.2 / Fig 1: MNIST (K=20) and CIFAR-10 (K sweep), ACGAN nets, B=5
IMAGE_ACGAN = PaperExperiment(
    name="image_acgan", num_agents=5,
    sync_intervals=(10, 20, 100, 500, 3000, 6000), default_K=20,
    batch_size=64, iterations=30000, opt="adam", lr_d=1e-3, lr_g=1e-3,
    notes="Table 1: Adam(b1=0.5, b2=0.999); 2 classes per agent")

# §4.2 / Fig 2: CelebA, 16 attribute classes over B=5 agents
CELEBA_ACGAN = PaperExperiment(
    name="celeba_acgan", num_agents=5,
    sync_intervals=(10, 20, 50, 100, 200), default_K=50,
    batch_size=128, iterations=16000, opt="adam", lr_d=2e-4, lr_g=1e-4,
    notes="Table 2: TTUR lr_D = 2 lr_G")

# §4.3 / Fig 3-4: PG&E household load + EV sessions, CGAN 1-D conv, B=5
TIMESERIES_CGAN = PaperExperiment(
    name="timeseries_cgan", num_agents=5, sync_intervals=(20,), default_K=20,
    batch_size=256, iterations=8000, opt="adam", lr_d=4e-4, lr_g=4e-4,
    notes="Table 3; split by climate zone / station category")


def scales_for(exp: PaperExperiment) -> TimeScales:
    """Equal learning rates: one time scale, a power decay under SGD (the
    2D system's (A2) schedule) and a constant under Adam; unequal ones: the
    constant two-time-scale pair (TTUR)."""
    if exp.lr_d == exp.lr_g:
        return equal_timescale(
            power_decay(exp.lr_d, tau=max(exp.iterations // 10, 1), p=0.6)
            if exp.opt == "sgd" else constant(exp.lr_d))
    return constant_ttur(exp.lr_d, exp.lr_g)


def optimizer_for(exp: PaperExperiment):
    """(opt_d, opt_g): plain SGD, or the paper's Adam(b1=0.5, b2=0.999)."""
    if exp.opt == "sgd":
        return SGD(), SGD()
    return Adam(b1=0.5, b2=0.999), Adam(b1=0.5, b2=0.999)


ALL_EXPERIMENTS = {
    e.name: e for e in (TOY_2D, MIXED_GAUSSIAN, SWISS_ROLL, IMAGE_ACGAN,
                        CELEBA_ACGAN, TIMESERIES_CGAN)
}
