"""FedGAN: Algorithm 1 of the paper (a port of ``repro.core.fedgan``).

State is agent-stacked: every parameter and optimizer leaf has a leading
(P, A) grid, B = P*A agents.  One round is K simultaneous local G/D steps
on every agent, then the strategy's sync, by default ``FedAvgSync()``: the
dataset-size-weighted parameter average of eq. (2), broadcast back (3).
The strategy may also transform each step's gradients (``grad_hook``: the
per-step average of the distributed-GAN baseline) and sync after every
segment of ``intra_interval`` steps (``segment_sync``: hierarchical).

The per-agent steps run as ``torch.func.vmap`` over the agent axis of
``torch.func.grad_and_value`` of the losses, and the optimizer update as
``vmap`` of the one-agent update, so one agent computes what it computes
in the reference.

With ``FedGANConfig(dp=DPSGD(...))`` each agent's gradients come from
``repro_torch.privacy.dpsgd.dp_grads``: per-example gradients (a vmap over
the examples nested inside the agent vmap), one joint clip, the mean and,
with a noise multiplier, Gaussian noise.  The noise is drawn from the
round's generator after each step's minibatch draws (``step_noise``):
``round`` takes that generator as ``gen``, ``round_from_data`` draws its
batches from it too, and ``draw_step`` makes a step's draws of both for a
captured round.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch import resolve_device
from repro_torch.core import strategies as sync_strategies
from repro_torch.dist import collectives
from repro_torch.dist.sharding import AgentShards
from repro_torch.optim import Adam, Optimizer, TimeScales, constant, equal_timescale
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class GANTask:
    """Adapter between FedGAN and a (G, D) model pair.

    init(generator) -> {"gen": ..., "disc": ...} on the CPU
    disc_loss(params, batch) -> scalar minimised in params["disc"]
    gen_loss(params, batch) -> scalar minimised in params["gen"]
    Losses detach the other player's contribution themselves.
    fused_grads(params, batch) -> (grad_disc, grad_gen, metrics), optional:
    when set, an agent's step takes its gradients from it, so that the two
    objectives can share one generator forward (the separate losses run
    the generator twice).  The port's losses take no random state, so
    neither does this hook.
    """

    init: Callable[[torch.Generator], Any]
    disc_loss: Callable[[Any, Any], torch.Tensor]
    gen_loss: Callable[[Any, Any], torch.Tensor]
    fused_grads: Callable[[Any, Any], Any] | None = None


@dataclasses.dataclass(frozen=True)
class FedGANConfig:
    agent_grid: tuple = (1, 5)   # (P pods, A agents/pod); B = P*A
    sync_interval: int = 20      # K
    strategy: Any = None         # SyncStrategy; None -> FedAvgSync()
    dp: Any = None               # repro_torch.privacy.DPSGD; None -> no DP
    # -- deprecated closed-world fields, kept as a shim --------------------
    mode: str = ""               # fedgan|distributed|local_only|hierarchical
    intra_interval: int = 0      # K1 of the hierarchical shim
    sync_dtype: Any = None       # a torch dtype: compressed sync
    average_opt_state: bool = False

    @property
    def num_agents(self) -> int:
        return self.agent_grid[0] * self.agent_grid[1]

    def resolve_strategy(self) -> sync_strategies.SyncStrategy:
        """The strategy this config denotes.  An explicit ``strategy``
        wins; a legacy ``mode`` string resolves through the deprecation
        shim.  Mixing the two is an error: the legacy knobs would be
        silently ignored otherwise."""
        if self.strategy is not None:
            legacy = {k: v for k, v in
                      (("mode", self.mode),
                       ("intra_interval", self.intra_interval),
                       ("sync_dtype", self.sync_dtype),
                       ("average_opt_state", self.average_opt_state)) if v}
            if legacy:
                raise ValueError(
                    f"strategy={self.strategy!r} conflicts with the "
                    f"deprecated config field(s) {sorted(legacy)}; move "
                    "them onto the strategy (e.g. "
                    "FedAvgSync(sync_dtype=...))")
            return self.strategy
        if self.mode:
            warnings.warn(
                f"FedGANConfig(mode={self.mode!r}) is deprecated; pass "
                "strategy= a repro_torch.core.strategies.SyncStrategy instead "
                f"(e.g. strategies.strategy_from_mode({self.mode!r}))",
                DeprecationWarning, stacklevel=2)
            return sync_strategies.strategy_from_mode(
                self.mode, intra_interval=self.intra_interval,
                sync_dtype=self.sync_dtype,
                average_opt_state=self.average_opt_state)
        return sync_strategies.FedAvgSync(sync_dtype=self.sync_dtype,
                                          average_opt_state=self.average_opt_state)

    def validate(self):
        self.resolve_strategy().validate(self)
        if self.dp is not None:
            self.dp.validate()

    @property
    def dp_noise(self) -> bool:
        """Whether the local steps draw DP-SGD noise."""
        return self.dp is not None and bool(self.dp.noise_multiplier)


def uniform_weights(cfg: FedGANConfig, device="cpu") -> torch.Tensor:
    P, A = cfg.agent_grid
    return torch.full((P, A), 1.0 / (P * A), dtype=torch.float32, device=device)


def dataset_weights(sizes) -> torch.Tensor:
    """p_i = |R_i| / sum_j |R_j| (paper §3.1), float32, shaped like
    ``sizes`` (e.g. (P, A))."""
    s = torch.as_tensor(sizes, dtype=torch.float32)
    return s / torch.sum(s)


def _flat(tree, B):
    """(P, A, ...) leaves -> (B, ...)."""
    return tree_map(lambda x: x.reshape((B,) + tuple(x.shape[2:])), tree)


def _grid(tree, P, A):
    """(B, ...) leaves -> (P, A, ...)."""
    return tree_map(lambda x: x.reshape((P, A) + tuple(x.shape[1:])), tree)


@dataclasses.dataclass(frozen=True)
class FedGAN:
    task: GANTask
    cfg: FedGANConfig
    opt_g: Optimizer = Adam()
    opt_d: Optimizer = Adam()
    scales: TimeScales = dataclasses.field(
        default_factory=lambda: equal_timescale(constant(1e-3)))
    weights: Any = None  # (P, A) p_i; None -> uniform

    def __post_init__(self):
        # the normalised weights, made once per device (see ``_w``)
        object.__setattr__(self, "_w_on", {})

    # ------------------------------------------------------------------
    def _w(self, device):
        """The normalised (P, A) float32 agent weights on ``device``, made
        there on the first call and kept: the uniform default is filled
        there, given ``weights`` are copied there once, so no round copies
        them from the host (a captured round could not)."""
        dev = torch.device(device)
        w = self._w_on.get(dev)
        if w is None:
            w = (uniform_weights(self.cfg, dev) if self.weights is None
                 else torch.as_tensor(self.weights, dtype=torch.float32).to(dev))
            w = self._w_on[dev] = w / torch.sum(w)
        return w

    def init_state(self, gen: torch.Generator, *, device="cuda") -> dict:
        """All agents start from the same (w_hat, theta_hat), Algorithm 1.
        Parameters are drawn on the CPU from ``gen`` and moved to
        ``device``; strategy-carried entries (error-feedback residuals)
        are merged in."""
        dev = resolve_device(device)
        P, A = self.cfg.agent_grid
        params = tree_map(lambda x: x.to(dev), self.task.init(gen))
        one = {"params": params, "opt_g": self.opt_g.init(params["gen"]),
               "opt_d": self.opt_d.init(params["disc"])}
        state = tree_map(lambda x: x.expand((P, A) + tuple(x.shape)).contiguous(),
                         one)
        state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
        state.update(self.cfg.resolve_strategy().init_round_state(self, state))
        return state

    # ------------------------------------------------------------------
    def _agent_grads(self, params, batch):
        """One agent's (grad_disc, grad_gen, losses)."""
        if self.task.fused_grads is not None:
            return self.task.fused_grads(params, batch)
        gd, ld = grad_and_value(
            lambda d: self.task.disc_loss({**params, "disc": d}, batch))(params["disc"])
        gg, lg = grad_and_value(
            lambda g: self.task.gen_loss({**params, "gen": g}, batch))(params["gen"])
        return gd, gg, {"d_loss": ld, "g_loss": lg}

    def step_noise(self, state, gen: torch.Generator):
        """One step's DP-SGD noise: standard normals shaped like the
        (P, A)-stacked discriminator then generator params, drawn from
        ``gen`` leaf by leaf on their device; None when the config draws no
        noise."""
        if not self.cfg.dp_noise:
            return None
        from repro_torch.privacy.dpsgd import noise_like
        return {"disc": noise_like(state["params"]["disc"], gen),
                "gen": noise_like(state["params"]["gen"], gen)}

    def _grads(self, params, batch, noise):
        """Every agent's (grad_disc, grad_gen, metrics), (B, ...) leaves:
        the plain minibatch gradients, or with ``dp`` the DP-SGD ones with
        ``noise`` ((B, ...) standard normals, or None)."""
        dp = self.cfg.dp
        if dp is None:
            return vmap(self._agent_grads)(params, batch)
        from repro_torch.privacy.dpsgd import dp_grads
        if noise is None:
            return vmap(lambda p, b: dp_grads(self._agent_grads, p, b, dp))(params, batch)
        return vmap(lambda p, b, nd, ng: dp_grads(self._agent_grads, p, b, dp, (nd, ng)))(
            params, batch, noise["disc"], noise["gen"])

    def _step(self, state, batch, strat, noise=None):
        """One simultaneous local step on every agent; ``batch`` leaves
        have leading (P, A) dims, ``noise`` is the step's DP-SGD noise
        (``step_noise``) or None.  The strategy's ``grad_hook`` sees the
        (P, A)-stacked gradients before either optimizer update.  Returns
        (state, per-step metrics: the agent means of the losses).

        On a mesh whose agent axes shard the state, every rank steps its own
        agents (``AgentShards``: the agent axes manual, tensor parallelism
        left to DTensor), and the hook and the metrics see all agents."""
        if self.cfg.dp_noise and noise is None:
            raise ValueError("dp has a noise multiplier: the step needs its noise "
                             "(FedGAN.round(..., gen=) draws it)")
        n = state["step"].to(torch.float32)
        lr_a, lr_b = self.scales.a(n), self.scales.b(n)
        view = AgentShards.of(state["params"])
        if view is None:
            params, opt_d, opt_g, metrics = self._local_step(
                state["params"], state["opt_d"], state["opt_g"], batch, noise, lr_a, lr_b,
                lambda gd, gg: strat.grad_hook(self, gd, gg, state))
        else:
            if self.cfg.dp is not None:
                raise NotImplementedError(
                    "DP-SGD on a mesh (per-example gradients of agent-sharded state) "
                    "is not ported; run the DP round unsharded")
            like = state["params"]

            def hook(gd, gg):
                gd, gg = strat.grad_hook(self, view.to_global(gd, like["disc"]),
                                         view.to_global(gg, like["gen"]), state)
                return view.local(gd), view.local(gg)

            local = view.local((state["params"], state["opt_d"], state["opt_g"], batch))
            params, opt_d, opt_g, metrics = self._local_step(
                *local, None, view.local(lr_a), view.local(lr_b), hook,
                gather=view.batch_dims(local[3]))
            P, A = tree_leaves(params)[0].shape[:2]
            params = view.to_global(params, like)
            opt_d = view.to_global(opt_d, state["opt_d"])
            opt_g = view.to_global(opt_g, state["opt_g"])
            metrics = view.to_global(_grid(metrics, P, A), tree_leaves(like)[0])
        new_state = {
            **state,  # strategy-carried entries (EF residuals) ride along
            "params": params, "opt_g": opt_g, "opt_d": opt_d,
            "step": state["step"] + 1,
        }
        return new_state, tree_map(torch.mean, metrics)

    def _local_step(self, params, opt_d, opt_g, batch, noise, lr_a, lr_b, hook, gather=None):
        """The agents' gradients (``hook`` applied to the (P, A)-stacked
        ones) and optimizer updates: (params, opt_d, opt_g) on the (P, A)
        grid, and the (B,) per-agent metrics.  ``gather`` (on a mesh: the
        mesh dims of the data parallelism inside an agent) gathers the
        weights' shards on those dims for the gradients, whose sums then go
        back to the weights' shards."""
        P, A = tree_leaves(params)[0].shape[:2]
        B = P * A
        flat = _flat(params, B)
        use = flat if gather is None else AgentShards.gathered(flat, gather)
        gd, gg, metrics = self._grads(use, _flat(batch, B),
                                      None if noise is None else _flat(noise, B))
        if gather is not None:
            gd = AgentShards.placed_like(gd, flat["disc"])
            gg = AgentShards.placed_like(gg, flat["gen"])
        gd, gg = hook(_grid(gd, P, A), _grid(gg, P, A))
        gd, gg = _flat(gd, B), _flat(gg, B)
        new_disc, new_opt_d = vmap(
            lambda p, g, s: self.opt_d.update(p, g, s, lr_a))(flat["disc"], gd, _flat(opt_d, B))
        new_gen, new_opt_g = vmap(
            lambda p, g, s: self.opt_g.update(p, g, s, lr_b))(flat["gen"], gg, _flat(opt_g, B))
        return (_grid({"gen": new_gen, "disc": new_disc}, P, A), _grid(new_opt_d, P, A),
                _grid(new_opt_g, P, A), metrics)

    def _run_round(self, state, batch_of):
        """K local steps (``batch_of(k)`` gives step k's (P, A, ...) batch
        and its DP-SGD noise or None), with the strategy's
        ``segment_sync`` after every ``intra_interval`` of them when it has
        one, then its ``round_sync``.  Metrics are stacked to (K,)
        tensors."""
        self.cfg.validate()
        strat = self.cfg.resolve_strategy()
        history = []
        for k in range(self.cfg.sync_interval):
            batch, noise = batch_of(k)
            state, m = self._step(state, batch, strat, noise)
            history.append(m)
            if strat.intra_interval and (k + 1) % strat.intra_interval == 0:
                state = strat.segment_sync(self, state)
        metrics = {key: torch.stack([m[key] for m in history])
                   for key in history[0]}
        return strat.round_sync(self, state), metrics

    def round(self, state, batches, gen: torch.Generator | None = None):
        """``batches``: dict of tensors with leading (K, P, A, ...).  Runs
        K local steps then syncs per the configured strategy.  ``gen``
        draws the DP-SGD noise (``step_noise``); a config with a noise
        multiplier needs it."""
        return self._run_round(state, lambda k: (
            tree_map(lambda x: x[k], batches),
            None if gen is None else self.step_noise(state, gen)))

    def round_from_data(self, state, data, gen: torch.Generator):
        """Sampling-aware round: the K minibatches are drawn on the device
        from ``data`` (anything with ``sample_step(generator) -> (P, A,
        batch, ...)``, e.g. ``DeviceFederatedData``) with ``gen``, each
        step's DP-SGD noise after its minibatch."""
        return self._run_round(state, lambda k: (data.sample_step(gen),
                                                 self.step_noise(state, gen)))

    def draw_step(self, state, data, gen: torch.Generator) -> dict:
        """One step's random draws from ``gen`` in ``round_from_data``'s
        order: the minibatch's (``data.draw_step``), then the DP-SGD noise
        (None without it)."""
        d = data.draw_step(gen)
        return {"data": d, "noise": self.step_noise(state, gen)}

    def round_from_draws(self, state, data, draws):
        """The round of ``round_from_data`` from its K steps' random draws
        made beforehand (``draw_step`` K times): step k trains on
        ``data.gather_step(draws[k]["data"])`` with ``draws[k]["noise"]``.
        A captured round (``repro_torch.run.graph``) takes its draws
        outside the graph so."""
        return self._run_round(state, lambda k: (data.gather_step(draws[k]["data"]),
                                                 draws[k]["noise"]))

    # ------------------------------------------------------------------
    def agent_params(self, state, p: int = 0, a: int = 0):
        return tree_map(lambda x: x[p, a], state["params"])

    def agent_opt_state(self, state, p: int = 0, a: int = 0):
        return {k: tree_map(lambda x: x[p, a], state[k]) for k in ("opt_g", "opt_d")}

    def averaged_params(self, state):
        """The intermediary's (w_n, theta_n): weighted average, no broadcast."""
        w = self._w(state["step"].device)
        return tree_map(lambda x: collectives.weighted_mean(x, w), state["params"])

    def comm_bytes_per_round(self, state) -> dict:
        """§3.2 accounting: FedGAN moves 2·M per agent per ROUND, the
        distributed baseline 2·M per STEP, plus the strategy's own wire
        bytes."""
        strat = self.cfg.resolve_strategy()
        params = self.agent_params(state)
        M_bytes = collectives.tree_bytes(params)
        K = self.cfg.sync_interval
        codec = getattr(strat, "codec", None)
        return {"param_bytes_M": M_bytes,
                "per_agent_per_round": {"fedgan": 2 * M_bytes,
                                        "distributed": 2 * M_bytes * K},
                "ratio": K, "strategy": strat.name,
                "codec": codec.name if codec is not None else None,
                "strategy_bytes_per_round": strat.bytes_per_round(
                    self.cfg, params, opt=self.agent_opt_state(state))}
