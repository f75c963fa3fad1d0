"""The paper's experiment configurations (a port of the image entry of
``repro.configs.paper_gans``; the other experiments are not ported yet)."""
from __future__ import annotations

import dataclasses


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


# §4.2 / Fig 1: MNIST (K=20) and CIFAR-10 (K sweep), ACGAN nets, B=5
IMAGE_ACGAN = PaperExperiment(
    name="image_acgan", num_agents=5,
    sync_intervals=(10, 20, 100, 500, 3000, 6000), default_K=20,
    batch_size=64, iterations=30000, opt="adam", lr_d=1e-3, lr_g=1e-3,
    notes="Table 1: Adam(b1=0.5, b2=0.999); 2 classes per agent")

ALL_EXPERIMENTS = {e.name: e for e in (IMAGE_ACGAN,)}
