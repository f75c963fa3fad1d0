"""FedGAN training launcher (a port of part of ``repro.launch.train``).

Runs the paper's image experiment on its synthetic stand-in data, on the
card unless told otherwise:

  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --codec int8 --steps 60          # int8 sync wire + error feedback (fused)
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --codec int4 --topk 0.25         # top-k then int4: the composed sync
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --strategy partial_sharing --codec int8   # generator-only sync
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --device cpu --steps 20

``--device cuda`` (the default) raises when no GPU is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.comm import codec_from_flags
from repro_torch.core import ACGAN, FedAvgSync, FedGAN, FedGANConfig, GANTask, \
    make_gan_task, strategies
from repro_torch.data import DeviceFederatedData, synthetic
from repro_torch.optim import Adam, constant, constant_ttur, equal_timescale


def acgan_task(hw=16, channels=3, num_classes=10, latent=62):
    from repro_torch.models.gan_nets import ACGANDiscriminator, ACGANGenerator
    G = ACGANGenerator(latent_dim=latent, num_classes=num_classes, image_hw=hw,
                       channels=channels)
    D = ACGANDiscriminator(num_classes=num_classes, image_hw=hw, channels=channels)
    return make_gan_task(G, D, ACGAN), (G, D)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything one simulated federated GAN run needs (agents stacked on
    one device).  ``build()`` gives the FedGAN, ``build_data()`` the
    device-resident pipeline, ``run_result()`` executes the round loop
    through :class:`repro_torch.run.RoundDriver`."""

    task: GANTask
    agent_data: list
    agent_grid: tuple = (1, 5)
    K: int = 20
    steps: int = 100
    batch_size: int = 64
    scales: Any = None              # None -> equal_timescale(constant(1e-3))
    opt_g: Any = dataclasses.field(default_factory=Adam)
    opt_d: Any = dataclasses.field(default_factory=Adam)
    strategy: Any = None            # SyncStrategy; None -> FedAvgSync
    sample_extra: Any = None
    seed: int = 0
    log_every: int = 1
    eval_every: int = 0             # rounds between eval-hook points
    eval_hooks: Any = ()
    device: str = "cuda"

    @property
    def n_rounds(self) -> int:
        return max(self.steps // self.K, 1)

    def build(self) -> FedGAN:
        return FedGAN(self.task,
                      FedGANConfig(agent_grid=self.agent_grid,
                                   sync_interval=self.K, strategy=self.strategy),
                      opt_g=self.opt_g, opt_d=self.opt_d,
                      scales=self.scales or equal_timescale(constant(1e-3)))

    def build_data(self) -> DeviceFederatedData:
        return DeviceFederatedData.from_agent_data(
            self.agent_data, self.agent_grid, self.batch_size,
            sample_extra=self.sample_extra, device=self.device)

    def run_result(self):
        """Execute through the round driver; returns its ``RunResult``."""
        from repro_torch.run.driver import RoundDriver
        fed = self.build()
        state = fed.init_state(torch.Generator().manual_seed(self.seed),
                               device=self.device)
        driver = RoundDriver(fed, self.build_data(), self.n_rounds,
                             log_every=self.log_every, eval_every=self.eval_every,
                             eval_hooks=self.eval_hooks,
                             verbose=bool(self.log_every))
        return driver.run(self.seed + 1, state=state)


def experiment_spec(name: str, *, K: int | None = None,
                    steps: int | None = None, seed: int = 0, strategy=None,
                    batch_size: int | None = None, log_every: int | None = None,
                    device="cuda") -> RunSpec:
    """The RunSpec of one of the paper's experiments on its synthetic
    stand-in data, built on ``device``.  Only ``image_acgan`` is ported:
    ACGAN nets on 16x16x3 images of 10 classes, B = 5 agents with two
    classes each, 2048 images per agent, K = 20, batch 64, Adam(0.5,
    0.999) at lr 1e-3 for both players."""
    from repro_torch.configs.paper_gans import ALL_EXPERIMENTS
    if name not in ALL_EXPERIMENTS:
        raise KeyError(f"experiment {name!r} is not ported; ported: "
                       f"{sorted(ALL_EXPERIMENTS)}")
    dev = resolve_device(device)
    exp = ALL_EXPERIMENTS[name]
    K = K or exp.default_K
    steps = steps or exp.iterations
    B, ncls, hw, latent, n = exp.num_agents, 10, 16, 62, 2048
    task, _ = acgan_task(hw=hw, num_classes=ncls, latent=latent)
    per = ncls // B
    gen = torch.Generator(device=dev).manual_seed(seed)
    agent_data = []
    for i in range(B):   # agent i holds classes [i * per, (i + 1) * per)
        lab = torch.randint(i * per, (i + 1) * per, (n,), generator=gen, device=dev)
        img = synthetic.sample_class_images(gen, n, lab, hw=hw, num_classes=ncls)
        agent_data.append({"x": img, "y": lab})

    def extra(g, shape):
        return {"z": torch.randn(shape + (latent,), generator=g, device=g.device)}

    adam = Adam(b1=0.5, b2=0.999)
    return RunSpec(
        task=task, agent_data=agent_data, agent_grid=(1, B), K=K, steps=steps,
        batch_size=batch_size or exp.batch_size,
        scales=constant_ttur(exp.lr_d, exp.lr_g), opt_d=adam, opt_g=adam,
        strategy=strategy, sample_extra=extra, seed=seed,
        log_every=max((steps // K) // 10, 1) if log_every is None else log_every,
        device=str(dev))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--experiment", required=True, choices=["image_acgan"])
    ap.add_argument("--K", type=int, default=0,
                    help="local steps per round (0 = experiment default)")
    ap.add_argument("--steps", type=int, default=0,
                    help="total local steps (0 = experiment default)")
    ap.add_argument("--strategy", default="",
                    choices=[""] + sorted(strategies.STRATEGIES))
    ap.add_argument("--codec", default="",
                    help="wire codec spec for the compressed sync "
                         "(repro_torch.comm): int8 | int4 | topk | chains "
                         "like topk+int8; error feedback on")
    ap.add_argument("--codec-bits", type=int, default=0, choices=[0, 4, 8],
                    help="quantizer bits; retunes (or appends) the codec's "
                         "quantizer stage")
    ap.add_argument("--topk", type=float, default=0.0,
                    help="top-k sparsification fraction; retunes (or "
                         "prepends) the codec's sparsifier stage")
    ap.add_argument("--average-opt-state", action="store_true",
                    help="FedAvg the optimizer moments along with the params")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="per-agent minibatch size (0 = experiment default)")
    ap.add_argument("--log-every", type=int, default=-1,
                    help="rounds between metric logs; 0 silences, "
                         "-1 = experiment default")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    return ap


def strategy_from_args(args) -> strategies.SyncStrategy | None:
    """CLI flags -> SyncStrategy (None keeps the default ``FedAvgSync()``).
    A knob the chosen strategy does not declare is an error, not a silent
    no-op.  A bare ``--codec`` or ``--average-opt-state`` implies the
    ``fedgan`` strategy."""
    codec = codec_from_flags(args.codec, bits=args.codec_bits, topk=args.topk)
    if not (args.strategy or codec is not None or args.average_opt_state):
        return None
    cls = strategies.STRATEGIES[args.strategy] if args.strategy else FedAvgSync
    fields = {f.name for f in dataclasses.fields(cls)}
    requested = {}
    if codec is not None:
        requested["codec"] = codec
    if args.average_opt_state:
        requested["average_opt_state"] = True
    stray = sorted(set(requested) - fields)
    if stray:
        name = args.strategy or "fedgan (implied by --codec)"
        raise ValueError(f"--strategy {name} does not accept {stray} "
                         f"(its knobs: {sorted(fields)})")
    return cls(**requested)


def main(argv=None):
    args = build_parser().parse_args(argv)
    strategy = strategy_from_args(args)
    spec = experiment_spec(
        args.experiment, K=args.K or None, steps=args.steps or None,
        strategy=strategy, batch_size=args.batch_size or None,
        log_every=None if args.log_every < 0 else args.log_every,
        device=args.device)
    result = spec.run_result()
    print(json.dumps({"device": spec.device, "rounds": spec.n_rounds,
                      **result.timings}))
    return result


if __name__ == "__main__":
    main()
