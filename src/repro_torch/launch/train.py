"""FedGAN training launcher (a port of ``repro.launch.train``).

Runs one of the paper's experiments (toy_2d, mixed_gaussian, swiss_roll,
image_acgan, celeba_acgan, timeseries_cgan) on its synthetic stand-in
data, or federated adversarial training of an assigned backbone
(``--arch``: the LM GAN at the arch's ``.smoke()`` width), on the card
unless told otherwise:

  PYTHONPATH=src python -m repro_torch.launch.train --experiment toy_2d
  PYTHONPATH=src python -m repro_torch.launch.train --experiment mixed_gaussian \
      --steps 2000 --eval-every 40     # FD and mode coverage every 40 rounds
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --codec int8 --steps 60          # int8 sync wire + error feedback (fused)
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --codec int4 --topk 0.25         # top-k then int4: the composed sync
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --strategy partial_sharing --codec int8   # generator-only sync
  PYTHONPATH=src python -m repro_torch.launch.train --experiment toy_2d \
      --strategy distributed           # the paper's per-step baseline
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --agents 8 --strategy hierarchical --intra-interval 5
  PYTHONPATH=src python -m repro_torch.launch.train --experiment swiss_roll \
      --strategy subsampled --participation 0.5 --sync-dtype bf16
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --ckpt-dir /tmp/ckpt             # checkpoints every n_rounds // 4 rounds
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --data-mode stream               # host-assembled rounds, pinned uploads
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
      --steps 4 --K 2 --device cpu     # the LM GAN of a reduced backbone
  PYTHONPATH=src python -m repro_torch.launch.train --experiment mixed_gaussian \
      --dp-noise 0.8 --eval-every 10   # per-agent DP-SGD; dp_epsilon per eval
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --secure-agg                     # pairwise-masked secure sum, same result
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --robust trimmed_mean --trim 1   # Byzantine-robust reduce
  PYTHONPATH=src python -m repro_torch.launch.train --experiment image_acgan \
      --a-total 1024 --a-active 5      # a 1024-client fleet paged through 5 slots

``--device cuda`` (the default) raises when no GPU is present.  The
legacy ``--mode`` still resolves through the deprecation shim.

``--data-mode`` defaults to ``device`` (every shard on the card, each step
sampled there), where the reference defaults to ``stream``: the
reference keeps ``stream`` for bit parity with its own blocking loop from
before its runtime, a loop the port never had.  ``stream`` runs the
reference's host pipeline, with its minibatch indices bit for bit.  A
fleet (``--a-total``) keeps its clients' data on the host and streams its
rounds; ``--data-mode device`` beside it is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.comm import codec_from_flags
from repro_torch.configs.paper_gans import ALL_EXPERIMENTS, optimizer_for, scales_for
from repro_torch.core import ACGAN, CONDITIONAL, FedAvgSync, FedGAN, FedGANConfig, \
    GANTask, make_gan_task, strategies
from repro_torch.data import (DeviceFederatedData, FleetRounds, StreamingFederatedData,
                              synthetic)
from repro_torch.models.gan_nets import one_hot
from repro_torch.optim import Adam, constant, equal_timescale


def toy2d_task():
    from repro_torch.models.gan_nets import Toy2DDiscriminator, Toy2DGenerator
    G, D = Toy2DGenerator(theta0=0.5), Toy2DDiscriminator(psi0=0.5)
    return make_gan_task(G, D), (G, D)


def mlp_gan_task(data_dim=2, latent=2, hidden=128):
    from repro_torch.models.gan_nets import MLPDiscriminator, MLPGenerator
    G = MLPGenerator(latent_dim=latent, out_dim=data_dim, hidden=hidden)
    D = MLPDiscriminator(in_dim=data_dim, hidden=hidden)
    return make_gan_task(G, D), (G, D)


def acgan_task(hw=16, channels=3, num_classes=10, latent=62):
    from repro_torch.models.gan_nets import ACGANDiscriminator, ACGANGenerator
    G = ACGANGenerator(latent_dim=latent, num_classes=num_classes, image_hw=hw,
                       channels=channels)
    D = ACGANDiscriminator(num_classes=num_classes, image_hw=hw, channels=channels)
    return make_gan_task(G, D, ACGAN), (G, D)


def cgan1d_task(seq_len=24, label_dim=5):
    from repro_torch.models.gan_nets import CGAN1DDiscriminator, CGAN1DGenerator
    G = CGAN1DGenerator(seq_len=seq_len, label_dim=label_dim)
    D = CGAN1DDiscriminator(seq_len=seq_len, label_dim=label_dim)
    return make_gan_task(G, D, CONDITIONAL), (G, D)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything one simulated federated GAN run needs (agents stacked on
    one device).  ``build()`` gives the FedGAN, ``build_data()`` the
    pipeline ``data_mode`` names (``"device"``: every shard on the device;
    ``"stream"``: rounds assembled on the host and uploaded),
    ``run_result()`` executes the round loop through
    :class:`repro_torch.run.RoundDriver`, ``rounds_per_chunk`` rounds a
    chunk on the device path.

    With ``a_total`` the spec runs the virtual-client fleet
    (:class:`repro_torch.run.VirtualClientDriver`): ``agent_data`` holds
    the ``a_total`` clients' data, ``agent_grid`` is the device slot grid
    of each round's cohort (drawn by ``ParticipationSchedule(
    participation_seed)``), stragglers follow ``straggler_policy``
    (``"block"`` or ``"defer"``).  The fleet streams its rounds from the
    host (``data_mode="stream"``) and runs them one by one (a cohort
    changes between rounds, so no chunk of rounds is captured)."""

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
    dp: Any = None                  # repro_torch.privacy.DPSGD; None -> no DP
    sample_extra: Any = None
    weights: Any = None             # (P, A) §3.1 agent weights; None -> uniform
    seed: int = 0
    log_every: int = 1
    ckpt_dir: str = ""              # checkpoints every n_rounds // 4 rounds
    eval_every: int = 0             # rounds between eval-hook points
    eval_hooks: Any = ()
    device: str = "cuda"
    data_mode: str = "device"       # "device" | "stream"
    rounds_per_chunk: int = 1       # device mode: rounds per captured chunk
    # -- virtual-client fleet (repro_torch.run.virtual) ---------------------
    a_total: int = 0                # fleet size; 0 = dense (all on the device)
    participation_seed: int = 0     # ParticipationSchedule seed
    straggler_policy: str = "block"  # "block" | "defer"

    def __post_init__(self):
        if self.a_total and self.rounds_per_chunk > 1:
            raise ValueError(
                f"rounds_per_chunk={self.rounds_per_chunk} with a_total: the fleet "
                "pages a new cohort's state into the slots between rounds, so its "
                "rounds run one by one and cannot be captured in chunks; leave "
                "rounds_per_chunk at 1")
        if self.a_total and self.data_mode != "stream":
            raise ValueError(
                f"data_mode={self.data_mode!r} with a_total: the fleet keeps its "
                "clients' data on the host and streams each cohort's rounds; "
                "use data_mode='stream'")

    @property
    def n_rounds(self) -> int:
        return max(self.steps // self.K, 1)

    @property
    def virtual(self) -> bool:
        """Whether this spec runs the virtual-client fleet (``a_total``
        set): a cohort of the ``a_total`` clients paged into the
        ``agent_grid`` slots each round."""
        return self.a_total > 0

    def build(self) -> FedGAN:
        return FedGAN(self.task,
                      FedGANConfig(agent_grid=self.agent_grid,
                                   sync_interval=self.K, strategy=self.strategy,
                                   dp=self.dp),
                      opt_g=self.opt_g, opt_d=self.opt_d,
                      scales=self.scales or equal_timescale(constant(1e-3)),
                      weights=self.weights)

    def build_data(self):
        """The ``FederatedData`` pipeline ``data_mode`` names."""
        if self.data_mode == "device":
            return DeviceFederatedData.from_agent_data(
                self.agent_data, self.agent_grid, self.batch_size,
                sample_extra=self.sample_extra, device=self.device)
        if self.data_mode == "stream":
            return StreamingFederatedData.from_agent_data(
                self.agent_data, self.agent_grid, self.batch_size, self.K,
                sample_extra=self.sample_extra, device=self.device)
        raise ValueError(f"unknown data_mode {self.data_mode!r} "
                         "(expected 'stream' or 'device')")

    def build_fleet(self):
        """The fleet's ``(FedGAN, FleetRounds)`` pair: the model on the
        ``agent_grid`` slot grid, the data of all ``a_total`` clients (host
        tensors)."""
        if len(self.agent_data) != self.a_total:
            raise ValueError(f"a_total={self.a_total} but agent_data holds "
                             f"{len(self.agent_data)} client datasets")
        return self.build(), FleetRounds(self.agent_data, self.agent_grid, self.batch_size,
                                         self.K, sample_extra=self.sample_extra)

    def run_result(self):
        """Execute through the round driver (the fleet's, with
        ``a_total``); returns its ``RunResult``.  The dense run inits from
        ``seed`` and draws its rounds from ``seed + 1``; the fleet splits
        ``seed + 1`` into both, as the reference's does."""
        from repro_torch.run.driver import RoundDriver
        if self.virtual:
            from repro_torch.core.participation import ParticipationSchedule
            from repro_torch.run.virtual import StragglerPolicy, VirtualClientDriver
            fed, fleet = self.build_fleet()
            driver = VirtualClientDriver(
                fed, fleet, self.n_rounds,
                schedule=ParticipationSchedule(seed=self.participation_seed),
                straggler=StragglerPolicy(mode=self.straggler_policy),
                log_every=self.log_every, verbose=bool(self.log_every),
                eval_every=self.eval_every, eval_hooks=self.eval_hooks,
                ckpt_dir=self.ckpt_dir,
                ckpt_every=max(self.n_rounds // 4, 1) if self.ckpt_dir else 0,
                device=self.device)
            return driver.run(self.seed + 1)
        fed = self.build()
        driver = RoundDriver(fed, self.build_data(), self.n_rounds,
                             log_every=self.log_every, eval_every=self.eval_every,
                             eval_hooks=self.eval_hooks, ckpt_dir=self.ckpt_dir,
                             ckpt_every=max(self.n_rounds // 4, 1) if self.ckpt_dir else 0,
                             rounds_per_chunk=self.rounds_per_chunk,
                             verbose=bool(self.log_every))
        # the driver holds the only reference to the initial state
        return driver.run(self.seed + 1, state=fed.init_state(
            torch.Generator().manual_seed(self.seed), device=self.device))

    def run(self):
        """Legacy entry point: returns (fed, state, history)."""
        return self.run_result().legacy_tuple()


def train_fedgan(task, *, agent_data, agent_grid, K, steps, batch_size, scales, opt_d,
                 opt_g, strategy=None, mode="", sample_extra=None, seed=0, log_every=1,
                 ckpt_dir="", weights=None, device="cuda"):
    """Compat wrapper over RunSpec (prefer ``RunSpec(...).run()`` directly);
    returns (fed, state, history)."""
    if strategy is None and mode:
        strategy = strategies.strategy_from_mode(mode)
    return RunSpec(task=task, agent_data=agent_data, agent_grid=agent_grid, K=K,
                   steps=steps, batch_size=batch_size, scales=scales, opt_g=opt_g,
                   opt_d=opt_d, strategy=strategy, sample_extra=sample_extra,
                   weights=weights, seed=seed, log_every=log_every, ckpt_dir=ckpt_dir,
                   device=device).run()


def _pooled_real(agent_data, seed: int = 0):
    """Cross-agent pooled real samples, shuffled so any prefix is an
    unbiased draw from the GLOBAL distribution (what the paper's metrics
    compare against, never one agent's slice).  Stays on the data's
    device."""
    xs = torch.cat([d["x"] for d in agent_data])
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(len(xs)))
    return xs[perm.to(xs.device)]


def experiment_spec(name: str, *, K: int | None = None,
                    steps: int | None = None, seed: int = 0, strategy=None,
                    batch_size: int | None = None,
                    agents: int | None = None, log_every: int | None = None,
                    eval_every: int = 0, device="cuda", ckpt_dir: str = "",
                    samples_per_agent: int | None = None, a_total: int = 0,
                    a_active: int = 0, participation_seed: int = 0,
                    straggler_policy: str = "block", dp=None,
                    data_mode: str | None = None, rounds_per_chunk: int = 1):
    """``(RunSpec, EvalSuite)`` for one of the paper's experiments on its
    synthetic stand-in data, built on ``device`` from a ``torch.Generator``
    seeded with ``seed``: the reference's recipe (nets, non-iid split,
    shard sizes, optimizers, schedules), the same distributions, other
    bits.  ``K``, ``steps``, ``batch_size``, ``agents`` (B; the modes,
    class slices and climate zones wrap past the experiment's own B, as in
    the reference), ``samples_per_agent`` and ``log_every`` override the
    experiment's defaults; ``eval_every`` wires the suite into the driver
    as an eval hook every that many rounds; ``ckpt_dir`` checkpoints the
    run every ``n_rounds // 4`` rounds.  ``data_mode`` picks the round
    pipeline: ``"stream"`` makes the agent data on ``device`` as
    ``"device"`` does, then moves it to the host, so both modes see the
    same data bits.  ``rounds_per_chunk`` runs the device path in chunks of
    that many rounds, captured on the card.  ``dp`` (a
    ``repro_torch.privacy.DPSGD``) turns on per-agent DP-SGD.

    ``a_total`` switches to the virtual-client fleet: the experiment's
    non-iid split is dealt over ``a_total`` clients (modes, class slices
    and climate zones wrap; each client's shard shrinks to
    ``samples_per_agent``, default 512, so a thousand-client fleet fits the
    host's memory), made on ``device`` and kept on the host, and each round
    the ``ParticipationSchedule(participation_seed)`` cohort of
    ``a_active`` (default the experiment's B) runs on the device slots.
    ``data_mode`` defaults to ``"device"``, and to ``"stream"`` for a
    fleet."""
    from repro_torch.run.evals import EvalSuite, eval_hook
    if name not in ALL_EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; known: {sorted(ALL_EXPERIMENTS)}")
    dev = resolve_device(device)
    exp = ALL_EXPERIMENTS[name]
    K = K or exp.default_K
    steps = steps or exp.iterations
    if a_total:
        if agents:
            raise ValueError("--agents conflicts with --a-total (the fleet "
                             "size IS the client count); use --a-active for "
                             "the per-round cohort size")
        B = a_total
        a_active = a_active or exp.num_agents
        if not 1 <= a_active <= a_total:
            raise ValueError(f"a_active={a_active} must be in [1, "
                             f"a_total={a_total}]")
    elif a_active or participation_seed or straggler_policy != "block":
        raise ValueError("a_active, participation_seed and straggler_policy set the "
                         "fleet's cohorts and stragglers: they need a_total")
    else:
        B = agents or exp.num_agents
    if samples_per_agent is None and a_total:
        # a thousand-client fleet lives on the host: smaller shards keep the
        # whole fleet's data in memory (dense runs keep the paper's sizes)
        samples_per_agent = 512
    if data_mode is None:
        data_mode = "stream" if a_total else "device"
    n_of = lambda default: samples_per_agent or default  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return lambda g, s: {"z": torch.randn(s + shape, generator=g, device=g.device)}

    if name == "toy_2d":
        task, (G, _) = toy2d_task()
        agent_data = [{"x": synthetic.sample_2d_segment(gen, n_of(4096), i, B)}
                      for i in range(B)]

        def uniform(g, shape):
            return 2 * torch.rand(shape, generator=g, device=g.device) - 1

        extra = lambda g, s: {"z": uniform(g, s)}
        suite = EvalSuite(real=_pooled_real(agent_data, seed),
                          sample_fake=lambda gp, g, n: G.apply(gp, uniform(g, (n,))))
    elif name in ("mixed_gaussian", "swiss_roll"):
        task, (G, _) = mlp_gan_task()
        if name == "mixed_gaussian":   # 8 modes on the circle, two per agent
            agent_data = [{"x": synthetic.sample_mixed_gaussian(
                gen, n_of(8192), mode_subset=[(2 * i) % 8, (2 * i + 1) % 8])}
                for i in range(B)]
            modes = synthetic.mixed_gaussian_modes(device=dev)
        else:
            agent_data = [{"x": synthetic.sample_swiss_roll(
                gen, n_of(8192), t_range=(0.25 + 0.75 * i / B, 0.25 + 0.75 * (i + 1) / B))}
                for i in range(B)]
            modes = None
        extra = normal(2)
        suite = EvalSuite(
            real=_pooled_real(agent_data, seed), modes=modes,
            sample_fake=lambda gp, g, n: G.apply(
                gp, torch.randn((n, 2), generator=g, device=g.device)))
    elif name in ("image_acgan", "celeba_acgan"):
        ncls = 16 if name == "celeba_acgan" else 10
        task, (G, _) = acgan_task(hw=16, num_classes=ncls)
        per = max(ncls // B, 1)
        agent_data = []
        for i in range(B):   # agent i holds classes [lo, lo + per), wrapping
            lo = (i * per) % ncls
            lab = torch.randint(lo, min(lo + per, ncls), (n_of(2048),), generator=gen,
                                device=dev)
            img = synthetic.sample_class_images(gen, n_of(2048), lab, hw=16,
                                                num_classes=ncls)
            agent_data.append({"x": img, "y": lab})
        extra = normal(62)

        def sample_images(gp, g, n):
            lab = torch.randint(0, ncls, (n,), generator=g, device=g.device)
            return G.apply(gp, torch.randn((n, 62), generator=g, device=g.device), lab)

        suite = EvalSuite(real=_pooled_real(agent_data, seed), sample_fake=sample_images)
    else:  # timeseries_cgan
        task, (G, _) = cgan1d_task()
        agent_data = []
        for i in range(B):
            cz = torch.full((n_of(4096),), i % 5, dtype=torch.int64, device=dev)  # 5 zones
            x = synthetic.sample_household_load(gen, n_of(4096), climate_zone=cz)
            agent_data.append({"x": x, "y": one_hot(cz, 5)})
        extra = normal(24)

        def sample_profiles(gp, g, n):
            y = one_hot(torch.randint(0, 5, (n,), generator=g, device=g.device), 5)
            return G.apply(gp, torch.randn((n, 24), generator=g, device=g.device), y)

        suite = EvalSuite(real=_pooled_real(agent_data, seed),
                          sample_fake=sample_profiles, kind="timeseries")

    if a_total:   # the fleet's data lives on the host
        agent_data = [{k: v.cpu() for k, v in d.items()} for d in agent_data]
    opt_d, opt_g = optimizer_for(exp)
    spec = RunSpec(
        task=task, agent_data=agent_data, agent_grid=(1, a_active) if a_total else (1, B),
        K=K, steps=steps,
        batch_size=batch_size or exp.batch_size, scales=scales_for(exp),
        opt_d=opt_d, opt_g=opt_g, strategy=strategy, dp=dp, sample_extra=extra, seed=seed,
        log_every=max((steps // K) // 10, 1) if log_every is None else log_every,
        ckpt_dir=ckpt_dir, eval_every=eval_every,
        eval_hooks=(eval_hook(suite, seed=seed),) if eval_every else (),
        device=str(dev), data_mode=data_mode, rounds_per_chunk=rounds_per_chunk,
        a_total=a_total, participation_seed=participation_seed,
        straggler_policy=straggler_policy)
    return spec, suite


def run_experiment(name: str, *, K: int | None, steps: int | None, seed: int,
                   strategy=None, dp=None, ckpt_dir: str = "", batch_size=None,
                   agents=None, log_every=None, eval_every: int = 0,
                   data_mode: str | None = None, a_total: int = 0, a_active: int = 0,
                   participation_seed: int = 0, straggler_policy: str = "block",
                   samples_per_agent: int | None = None, device="cuda"):
    """One paper experiment end to end through :func:`experiment_spec`;
    returns (fed, state, history)."""
    spec, _ = experiment_spec(
        name, K=K, steps=steps, seed=seed, strategy=strategy, dp=dp,
        ckpt_dir=ckpt_dir, batch_size=batch_size, agents=agents,
        log_every=log_every, eval_every=eval_every, data_mode=data_mode,
        a_total=a_total, a_active=a_active, participation_seed=participation_seed,
        straggler_policy=straggler_policy, samples_per_agent=samples_per_agent,
        device=device)
    return spec.run()


def arch_smoke_spec(arch: str, *, steps: int, K: int, seed: int, strategy=None,
                    dp=None, ckpt_dir: str = "", batch_size: int | None = None,
                    agents: int | None = None, log_every: int | None = None,
                    data_mode: str = "device", rounds_per_chunk: int = 1,
                    device="cuda") -> RunSpec:
    """RunSpec for federated adversarial training of a reduced assigned
    backbone (see :func:`run_arch_smoke`), the reference's recipe: the
    arch's ``.smoke()`` config, ``agents`` (default 4) agents on a (1, B)
    grid, each with 256 token sequences of T = 32 from
    ``sample_agent_tokens`` (the reference's tokens bit for bit for the
    same ``seed``; an audio arch's agents also hold 256 frames each from
    ``sample_audio_frames``), minibatches of ``batch_size`` (default 8), Adam under
    ``equal_timescale(constant(1e-3))``.  ``data_mode`` defaults to the
    port's ``device``, as ``experiment_spec``'s does; ``dp`` turns on
    per-agent DP-SGD."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_lm_gan_task
    dev = resolve_device(device)
    cfg = get_config(arch).smoke()
    B, T = agents or 4, 32
    rng = prng.key(seed)
    agent_data = []
    for i in range(B):
        d = {"tokens": synthetic.sample_agent_tokens(
            rng, 256, T, cfg.vocab_size, agent=i, num_agents=B)}
        if cfg.family == "audio":
            d["frames"] = synthetic.sample_audio_frames(seed, 256, cfg.encoder_seq,
                                                        cfg.d_model, agent=i)
        agent_data.append(d)
    return RunSpec(
        task=make_lm_gan_task(cfg), agent_data=agent_data, agent_grid=(1, B), K=K,
        steps=steps, batch_size=batch_size or 8, scales=equal_timescale(constant(1e-3)),
        opt_d=Adam(), opt_g=Adam(), strategy=strategy, dp=dp, seed=seed,
        log_every=1 if log_every is None else log_every, ckpt_dir=ckpt_dir,
        device=str(dev), data_mode=data_mode, rounds_per_chunk=rounds_per_chunk)


def run_arch_smoke(arch: str, *, steps: int, K: int, seed: int, strategy=None,
                   dp=None, ckpt_dir: str = "", batch_size=None, agents=None,
                   log_every=None, data_mode: str = "device", device="cuda"):
    """Federated adversarial training of a reduced assigned backbone;
    returns the driver's ``RunResult``.  With ``ckpt_dir`` the run
    checkpoints its FedGAN state, which a ``repro_torch.serve`` engine can
    hot-reload (``CheckpointWatcher``) and serve."""
    return arch_smoke_spec(
        arch, steps=steps, K=K, seed=seed, strategy=strategy, dp=dp,
        ckpt_dir=ckpt_dir, batch_size=batch_size, agents=agents,
        log_every=log_every, data_mode=data_mode, device=device).run_result()


_SYNC_DTYPES = {"": None, "f32": torch.float32, "bf16": torch.bfloat16,
                "bfloat16": torch.bfloat16, "f16": torch.float16}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--experiment", default="", choices=sorted(ALL_EXPERIMENTS))
    ap.add_argument("--arch", default="",
                    help="federated adversarial training of this assigned "
                         "backbone at its .smoke() width (the LM GAN)")
    ap.add_argument("--K", type=int, default=0,
                    help="local steps per round (0 = experiment default)")
    ap.add_argument("--steps", type=int, default=0,
                    help="total local steps (0 = experiment default)")
    ap.add_argument("--strategy", default="",
                    choices=[""] + sorted(strategies.STRATEGIES))
    ap.add_argument("--mode", default="",
                    help="DEPRECATED: legacy mode string (use --strategy)")
    ap.add_argument("--intra-interval", type=int, default=0,
                    help="hierarchical: steps between intra-pod averages")
    ap.add_argument("--sync-dtype", default="", choices=sorted(_SYNC_DTYPES),
                    help="wire dtype for compressed sync (e.g. bf16)")
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
    ap.add_argument("--participation", type=float, default=0.0,
                    help="subsampled: per-round participating fraction")
    ap.add_argument("--warmup-rounds", type=int, default=0,
                    help="adaptive_k: rounds that sync every round")
    ap.add_argument("--sync-every", type=int, default=0,
                    help="adaptive_k: post-warmup rounds between syncs")
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="DP-SGD per-example clip norm C (enables DP; "
                         "defaults to 1.0 when only --dp-noise is given)")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="DP-SGD noise multiplier sigma (0 = clip-only)")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="delta at which the accountant reports epsilon")
    ap.add_argument("--secure-agg", action="store_true",
                    help="pairwise-mask secure summing at the sync "
                         "(bit-identical result; refuses --codec/--sync-dtype)")
    ap.add_argument("--robust", default="",
                    choices=["", "trimmed_mean", "median"],
                    help="Byzantine-robust aggregation (shorthand for "
                         "--strategy trimmed_mean|median)")
    ap.add_argument("--trim", type=int, default=0,
                    help="trimmed_mean: agents trimmed per tail (default 1)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the run's seed (and --secure-agg's mask seed)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint the state here every n_rounds // 4 rounds")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="per-agent minibatch size (0 = experiment default)")
    ap.add_argument("--agents", type=int, default=0,
                    help="number of agents B (0 = experiment default)")
    ap.add_argument("--samples-per-agent", type=int, default=0,
                    help="per-agent dataset size (0 = experiment default)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="rounds between scorings of the intermediary's "
                         "generator (repro_torch.evals; 0 = none)")
    ap.add_argument("--log-every", type=int, default=-1,
                    help="rounds between metric logs; 0 silences, "
                         "-1 = experiment default")
    ap.add_argument("--data-mode", default=None, choices=["device", "stream"],
                    help="round data pipeline: device-resident sampling (the "
                         "port's default) or host-streaming rounds (the "
                         "reference's default; a fleet's only pipeline)")
    ap.add_argument("--a-total", type=int, default=0,
                    help="virtual-client fleet size (0 = dense: every agent "
                         "on the device)")
    ap.add_argument("--a-active", type=int, default=0,
                    help="fleet: clients per round on the device slots "
                         "(0 = experiment default B)")
    ap.add_argument("--straggler-policy", default="block", choices=["block", "defer"],
                    help="fleet: what a planted-late client does (block: the "
                         "round waits; defer: its delta merges later, decayed)")
    ap.add_argument("--participation-seed", type=int, default=0,
                    help="fleet: seed of the per-round cohort draw")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    return ap


def strategy_from_args(args) -> strategies.SyncStrategy | None:
    """CLI flags -> SyncStrategy (None keeps the default ``FedAvgSync()``).
    A knob the chosen strategy does not declare is an error, not a silent
    no-op.  ``--robust`` is shorthand for ``--strategy trimmed_mean|median``
    and conflicts with another ``--strategy``.  Without ``--strategy`` and
    ``--mode``, any strategy knob (``--codec``, ``--sync-dtype``,
    ``--secure-agg``, ``--average-opt-state``, ``--intra-interval``,
    ``--participation``, ``--warmup-rounds``, ``--sync-every``,
    ``--trim``) implies the ``fedgan`` strategy; the reference does so for
    ``--codec`` and ``--secure-agg`` alone and drops the others unread.
    Beside ``--mode``, ``--codec`` and ``--secure-agg`` need ``--strategy``,
    as in the reference."""
    sync_dtype = _SYNC_DTYPES[args.sync_dtype]
    codec = codec_from_flags(args.codec, bits=args.codec_bits, topk=args.topk)
    if codec is not None and args.sync_dtype:
        raise ValueError(
            "--codec and --sync-dtype are both wire compressions; pick one "
            "(chain codecs via --codec a+b instead)")
    robust = getattr(args, "robust", "")
    if robust:
        if args.strategy and args.strategy != robust:
            raise ValueError(f"--robust {robust} conflicts with "
                             f"--strategy {args.strategy}; pick one")
        args.strategy = robust
    secure = getattr(args, "secure_agg", False)
    requested = {}
    if args.sync_dtype:
        requested["sync_dtype"] = sync_dtype
    if codec is not None:
        requested["codec"] = codec
    if secure:
        from repro_torch.privacy import SecureAgg
        requested["secure_agg"] = SecureAgg(seed=args.seed)
    if args.average_opt_state:
        requested["average_opt_state"] = True
    if args.intra_interval:
        requested["intra_interval"] = args.intra_interval
    if args.participation:
        requested["fraction"] = args.participation
    if args.warmup_rounds:
        requested["warmup_rounds"] = args.warmup_rounds
    if args.sync_every:
        requested["sync_every"] = args.sync_every
    if getattr(args, "trim", 0):
        requested["trim"] = args.trim
    if args.strategy or (requested and not args.mode):
        cls = strategies.STRATEGIES[args.strategy] if args.strategy else FedAvgSync
        fields = {f.name for f in dataclasses.fields(cls)}
        stray = sorted(set(requested) - fields)
        if stray:
            name = args.strategy or "fedgan (implied by the strategy flags)"
            raise ValueError(f"--strategy {name} does not accept {stray} "
                             f"(its knobs: {sorted(fields)})")
        return cls(**requested)
    if args.mode:
        if codec is not None:
            raise ValueError("--codec requires --strategy (the legacy "
                             "--mode strings predate the codec axis)")
        if secure:
            raise ValueError("--secure-agg requires --strategy (the legacy "
                             "--mode strings predate the privacy axis)")
        return strategies.strategy_from_mode(
            args.mode, intra_interval=args.intra_interval,
            sync_dtype=sync_dtype, average_opt_state=args.average_opt_state)
    return None


def dp_from_args(args):
    """CLI flags -> ``repro_torch.privacy.DPSGD`` (None when no DP flag is
    set).  ``--dp-noise`` alone enables DP at the default clip of 1.0."""
    if not (getattr(args, "dp_clip", 0.0) or getattr(args, "dp_noise", 0.0)):
        return None
    from repro_torch.privacy import DPSGD
    return DPSGD(clip=args.dp_clip or 1.0, noise_multiplier=args.dp_noise,
                 delta=getattr(args, "dp_delta", 1e-5))


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if bool(args.experiment) == bool(args.arch):
        ap.error("need exactly one of --experiment and --arch")
    if args.arch and (args.a_total or args.a_active):
        ap.error("--a-total/--a-active need --experiment (a backbone smoke run "
                 "has no fleet)")
    strategy = strategy_from_args(args)
    overrides = dict(dp=dp_from_args(args),
                     batch_size=args.batch_size or None, agents=args.agents or None,
                     log_every=None if args.log_every < 0 else args.log_every,
                     device=args.device, ckpt_dir=args.ckpt_dir)
    if args.experiment:
        spec, _ = experiment_spec(
            args.experiment, K=args.K or None, steps=args.steps or None, seed=args.seed,
            strategy=strategy, eval_every=args.eval_every,
            samples_per_agent=args.samples_per_agent or None, a_total=args.a_total,
            a_active=args.a_active, participation_seed=args.participation_seed,
            straggler_policy=args.straggler_policy, data_mode=args.data_mode, **overrides)
    else:
        if args.eval_every:
            ap.error("--eval-every needs --experiment (no eval suite exists "
                     "for backbone smoke runs)")
        if args.samples_per_agent:
            ap.error("--samples-per-agent needs --experiment (a backbone smoke "
                     "run holds 256 sequences an agent)")
        spec = arch_smoke_spec(args.arch, steps=args.steps or 20, K=args.K or 5,
                               seed=args.seed, strategy=strategy,
                               data_mode=args.data_mode or "device", **overrides)
    result = spec.run_result()
    for e in result.evals:
        print(json.dumps({"eval": True, **e}))
    print(json.dumps({"device": spec.device, "rounds": spec.n_rounds,
                      **result.timings}))
    return result


if __name__ == "__main__":
    main()
