"""Sync strategies (a port of ``repro.core.strategies``).

A :class:`SyncStrategy` owns when, what and how agents sync, and its own
§3.2 wire-byte accounting.  Hooks called by ``FedGAN``:

  ``validate(cfg)``              static config check
  ``init_round_state(fed, st)``  extra state carried across rounds (the
                                 error-feedback residuals of a coded sync)
  ``state_axes()``               "client" (agent-stacked) or "shared" per
                                 carried entry
  ``intra_interval``             nonzero splits the K local steps into
                                 segments of this length (must divide K)
  ``grad_hook(fed, gd, gg, st)`` per-step transform of the (P, A)-stacked
                                 gradients, before the optimizer updates
  ``segment_sync(fed, st)``      after every ``intra_interval`` segment
  ``round_sync(fed, st)``        after the K local steps
  ``bytes_per_round(cfg, params, opt=None)``
                                 per-agent send+receive wire bytes per round

Ported: ``LocalOnly``, ``FedAvgSync`` (plain average, ``sync_dtype``
cast, fused and composed coded sync, the pairwise-masked secure sum),
``PartialSharing``, ``SubsampledFedAvg``, ``AdaptiveK``,
``PerStepGradAvg`` (the paper's distributed-GAN baseline),
``Hierarchical`` and the Byzantine-robust ``TrimmedMeanSync`` and
``CoordinateMedianSync``.  ``check_async_mergeable`` refuses what the
fleet's buffered async merge (``repro_torch.run.async_agg``) cannot
replay as a weighted sum of deltas.

``AdaptiveK`` and ``SubsampledFedAvg`` decide on the host from the round
index, which they read from the device once per round (a host wait);
every other strategy syncs without one.  They say so with
``reads_round_on_host``: the driver runs their rounds eagerly even inside
a chunk of ``rounds_per_chunk``, since a captured round cannot read the
device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch import prng
from repro_torch.dist import collectives
from repro_torch.tree import tree_map

_OPT_KEY = {"gen": "opt_g", "disc": "opt_d"}


def _select(mask, new, old):
    """Per-agent select: ``mask`` (P, A) bool -> ``new`` where set, else
    ``old``, leaf by leaf."""
    return tree_map(
        lambda a, x: torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 2)), a, x),
        new, old)


def _fedavg(fed, state, *, subtrees, average_opt_state, sync_dtype=None, mask=None,
            codec=None, error_feedback=True, reduce=None, secure_agg=None, fused=None):
    """The eq. (2)+(3) aggregation of ``subtrees``: weighted average over
    (P, A), broadcast back.  With a participation ``mask`` ((P, A) bool on
    the state's device) the weights are masked and renormalised, and the
    agents outside it keep their local values, their uplink residuals
    included (they never hit the wire this round); the downlink residual
    updates regardless.  With ``codec`` the sync runs through
    ``collectives.coded_sync`` and, with ``error_feedback``, updates the
    per-agent uplink residuals (``state["ef"]``) and the shared downlink
    residual (``state["ef_down"]``).

    ``reduce`` (``collectives.make_robust_reduce``) takes the weighted
    mean's place on the plain and the coded paths.  ``secure_agg`` routes
    the plain path through ``collectives.masked_sync``, each synced tree
    with its own fold (``salt``) of the round's mask key, so no pad is
    reused."""
    w = fed._w(state["step"].device)
    if mask is not None:
        w = w * mask
        w = w / torch.sum(w)

    def keep(new, old):
        return new if mask is None else _select(mask, new, old)

    def avg(tree, salt):
        if secure_agg is not None:
            k = prng.fold_in_t(secure_agg.round_key(state["step"]), salt)
            return keep(collectives.masked_sync(tree, w, k, reduce=reduce), tree)
        return keep(collectives.average_agents(tree, w, sync_dtype=sync_dtype,
                                               reduce=reduce), tree)

    new = dict(state)
    params = dict(state["params"])
    if codec is None:
        for i, k in enumerate(subtrees):
            params[k] = avg(state["params"][k], i)
    else:
        use_ef = error_feedback and "ef" in state
        ef = dict(state["ef"]) if use_ef else None
        ef_down = dict(state["ef_down"]) if use_ef else None
        for k in subtrees:
            synced, e2, ed2 = collectives.coded_sync(
                state["params"][k], w, codec,
                ef=ef[k] if use_ef else None,
                ef_down=ef_down[k] if use_ef else None, reduce=reduce, fused=fused)
            params[k] = keep(synced, state["params"][k])
            if use_ef:
                ef[k], ef_down[k] = keep(e2, ef[k]), ed2
        if use_ef:
            new["ef"], new["ef_down"] = ef, ef_down
    new["params"] = params
    if average_opt_state:
        for i, k in enumerate(subtrees):
            opt = state[_OPT_KEY[k]]
            if codec is None:
                new[_OPT_KEY[k]] = avg(opt, i + len(subtrees))
            else:
                # the moments ride the coded wire too, without residuals:
                # they are re-estimated every step anyway
                synced = collectives.coded_sync(opt, w, codec, reduce=reduce,
                                                fused=fused)[0]
                new[_OPT_KEY[k]] = keep(synced, opt)
    return new


def _round_index(fed, state) -> int:
    """The index of the round that just ended, ``step // K - 1``.  Reading
    the device's step counter is a host wait: only the strategies whose
    sync depends on the round (AdaptiveK, SubsampledFedAvg) call this, once
    per round."""
    return int(state["step"]) // fed.cfg.sync_interval - 1


class SyncStrategy:
    """Base protocol; the defaults are the never-sync ablation."""

    name = "local_only"
    intra_interval = 0
    reads_round_on_host = False   # True: the sync reads the round index on the host

    def validate(self, cfg):
        pass

    def init_round_state(self, fed, state) -> dict:
        return {}

    def state_axes(self) -> dict:
        return {}

    def grad_hook(self, fed, grad_disc, grad_gen, state):
        return grad_disc, grad_gen

    def segment_sync(self, fed, state):
        return state

    def round_sync(self, fed, state):
        return state

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class LocalOnly(SyncStrategy):
    """Never sync (ablation lower bound)."""


@dataclasses.dataclass(frozen=True)
class FedAvgSync(SyncStrategy):
    """The paper's Algorithm 1 intermediary: K local steps, then a
    dataset-size-weighted parameter average of ``subtrees``.

    ``sync_dtype`` (a torch dtype) casts the leaves to a wire type for the
    average (compressed sync); ``average_opt_state`` averages the
    optimizer moments of the synced subtrees too.  ``codec`` (a
    ``repro_torch.comm.Codec``: ``IntQuant``, ``TopK`` or a ``Sequential``
    chain) ships both directions of the sync encoded instead; with
    ``error_feedback`` each agent carries an uplink residual and the
    intermediary a downlink residual.  ``codec`` and ``sync_dtype`` are
    exclusive.  ``fused_sync`` picks the path of the coded sync (the
    values are the same): None lets ``collectives.coded_sync`` fuse the
    float32 leaves through the qsync kernel when the codec has a
    ``fused_sync_spec``; False forces the composed per-leaf pipeline (the
    qpack kernels around the fedavg reduce); True requires the fused path
    and fails validation when the codec cannot ride it.  ``secure_agg`` (a
    ``repro_torch.privacy.SecureAgg``) routes the sync through
    ``collectives.masked_sync``: pairwise one-time-pad masking of the wire
    image with the weight folded in agent-side, a bit-identical result.
    It refuses to stack with anything that needs per-agent decoding at the
    server (``codec``, ``sync_dtype``) or per-agent values (subsampling,
    the robust reduces)."""

    sync_dtype: Any = None
    average_opt_state: bool = False
    subtrees: tuple = ("gen", "disc")
    codec: Any = None
    error_feedback: bool = True
    secure_agg: Any = None
    fused_sync: Any = None
    name = "fedgan"

    def validate(self, cfg):
        bad = [k for k in self.subtrees if k not in _OPT_KEY]
        if bad or not self.subtrees:
            raise ValueError(f"subtrees must be a non-empty subset of "
                             f"{tuple(_OPT_KEY)}, got {self.subtrees}")
        if self.codec is not None:
            self.codec.validate()
            if self.sync_dtype is not None:
                raise ValueError(
                    "codec= and sync_dtype= are both wire compressions; "
                    "pick one (chain codecs with repro_torch.comm.Sequential "
                    "instead of stacking a dtype cast on top)")
        if self.fused_sync:
            if self.codec is None:
                raise ValueError(
                    "fused_sync=True needs a codec= — the fused path IS the "
                    "coded sync; the plain average has nothing to fuse")
            if self.codec.fused_sync_spec() is None:
                raise ValueError(
                    f"fused_sync=True needs a codec with a fused_sync_spec; "
                    f"{self.codec.name!r} reshapes the payload and can only "
                    "run the composed per-leaf pipeline")
            if self.sync_reduce() is not None:
                raise ValueError(
                    "fused_sync=True cannot apply a robust reduce: the "
                    "fused kernel hard-wires the weighted mean — drop "
                    "fused_sync or fall back to the composed pipeline")
        if self.secure_agg is not None:
            self.secure_agg.validate()
            if self.codec is not None:
                raise ValueError(
                    "secure_agg= cannot ride a codec= wire: decoding a "
                    "lossy payload happens per agent at the server, which "
                    "reveals exactly the individual updates the masking "
                    "hides; pick one")
            if self.sync_dtype is not None:
                raise ValueError(
                    "secure_agg= pads the 32-bit wire image; sync_dtype= "
                    "re-encodes it per agent and breaks the pad "
                    "cancellation; pick one")

    def init_round_state(self, fed, state) -> dict:
        if self.codec is None or not self.error_feedback:
            return {}
        return {
            # per-agent uplink residuals, agent-stacked like the params
            "ef": {k: tree_map(torch.zeros_like, state["params"][k])
                   for k in self.subtrees},
            # the intermediary's downlink residual: one shared copy
            "ef_down": {k: tree_map(lambda x: x.new_zeros(x.shape[2:]),
                                    state["params"][k]) for k in self.subtrees},
        }

    def state_axes(self) -> dict:
        if self.codec is None or not self.error_feedback:
            return {}
        return {"ef": "client", "ef_down": "shared"}

    def participation_mask(self, fed, state):
        """(P, A) bool mask of the agents taking part in this round's
        sync, on the state's device, or None for all."""
        return None

    def sync_reduce(self):
        """The pluggable per-leaf aggregate, or None for the weighted mean.
        The robust strategies override it."""
        return None

    def round_sync(self, fed, state):
        return _fedavg(fed, state, subtrees=self.subtrees,
                       average_opt_state=self.average_opt_state,
                       sync_dtype=self.sync_dtype, codec=self.codec,
                       error_feedback=self.error_feedback,
                       mask=self.participation_mask(fed, state),
                       reduce=self.sync_reduce(), secure_agg=self.secure_agg,
                       fused=self.fused_sync)

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        wire = sum(collectives.sync_bytes(params[k], sync_dtype=self.sync_dtype,
                                          codec=self.codec)
                   for k in self.subtrees)
        if self.average_opt_state and opt is not None:
            wire += sum(collectives.sync_bytes(opt[_OPT_KEY[k]],
                                               sync_dtype=self.sync_dtype,
                                               codec=self.codec)
                        for k in self.subtrees if _OPT_KEY[k] in opt)
        return 2 * wire  # send + receive, once per round


@dataclasses.dataclass(frozen=True)
class PartialSharing(FedAvgSync):
    """PS-FedGAN-style generator-only sharing (Wijesinghe et al. 2023):
    the intermediary averages the ``gen`` subtree; every discriminator
    stays local, adapted to its agent's data."""

    subtrees: tuple = ("gen",)
    name = "partial_sharing"


# warn-once latch of the mask_seed deprecation (reset by tests)
_MASK_SEED_WARNED = False


@dataclasses.dataclass(frozen=True)
class SubsampledFedAvg(FedAvgSync):
    """Partial participation: each round ``round(fraction * B)`` agents
    (at least one) are drawn from the round index and the participation
    mask is folded into the weights: the participants average among
    themselves and receive the result, the others keep their local state.

    The draw comes from a ``ParticipationSchedule`` (``schedule=``), the
    reference's own bits (``repro_torch.core.participation``).  The old
    ``mask_seed=`` is a deprecated alias of
    ``schedule=ParticipationSchedule(seed=...)``.

    The draw reads the round index from the device on the host, so the
    round cannot be captured: the driver runs it eagerly inside a chunk
    of ``rounds_per_chunk`` and reports ``captured: False``."""

    fraction: float = 0.5
    mask_seed: Any = None       # deprecated: use schedule=
    schedule: Any = None        # ParticipationSchedule; None -> seed 0
    name = "subsampled"
    reads_round_on_host = True

    def __post_init__(self):
        global _MASK_SEED_WARNED
        if self.mask_seed is not None and not _MASK_SEED_WARNED:
            # once per process: sweeps build many strategy instances
            _MASK_SEED_WARNED = True
            warnings.warn(
                "SubsampledFedAvg(mask_seed=...) is deprecated: the "
                "participation draw is owned by repro_torch.core.participation."
                "ParticipationSchedule so the sync's mask and the "
                "virtual-client scheduler cannot diverge — pass "
                "schedule=ParticipationSchedule(seed=...) instead",
                DeprecationWarning, stacklevel=3)

    def validate(self, cfg):
        super().validate(cfg)
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        if self.mask_seed is not None and self.schedule is not None:
            raise ValueError(
                "mask_seed= is the deprecated spelling of schedule="
                "ParticipationSchedule(seed=...); passing both would leave "
                "two competing seed streams — drop mask_seed")
        self.resolve_schedule().validate(cfg.num_agents)
        if self.secure_agg is not None:
            raise ValueError(
                "secure_agg= needs every pair's both mask halves on the "
                "wire; per-round dropouts (subsampled participation) break "
                "the cancellation — real SecAgg recovers dropped seeds via "
                "a protocol this simulation does not model")

    def resolve_schedule(self):
        """The single sampling source of this strategy's cohort draws."""
        from repro_torch.core.participation import ParticipationSchedule
        if self.schedule is not None:
            return self.schedule
        return ParticipationSchedule(
            seed=0 if self.mask_seed is None else int(self.mask_seed))

    def num_participants(self, cfg) -> int:
        return max(1, int(round(self.fraction * cfg.num_agents)))

    def participation_mask(self, fed, state):
        P, A = fed.cfg.agent_grid
        m = self.num_participants(fed.cfg)
        if m == P * A:
            return None
        mask = self.resolve_schedule().mask(_round_index(fed, state), (P, A), m)
        return torch.from_numpy(mask).to(state["step"].device)

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        # fleet average per agent: only m of B agents hit the wire a round
        full = super().bytes_per_round(cfg, params, opt)
        return full * self.num_participants(cfg) // cfg.num_agents


@dataclasses.dataclass(frozen=True)
class AdaptiveK(FedAvgSync):
    """Warmup-K: sync every round for the first ``warmup_rounds`` rounds
    (agents drift fastest early), then only every ``sync_every`` rounds,
    an effective interval of K·sync_every at steady state.  A skipped
    round launches nothing.

    Whether a round syncs is decided on the host from the round index,
    read from the device, so the round cannot be captured: the driver runs
    it eagerly inside a chunk of ``rounds_per_chunk`` and reports
    ``captured: False``."""

    warmup_rounds: int = 4
    sync_every: int = 2
    name = "adaptive_k"
    reads_round_on_host = True

    def validate(self, cfg):
        super().validate(cfg)
        if self.warmup_rounds < 0 or self.sync_every < 1:
            raise ValueError("need warmup_rounds >= 0 and sync_every >= 1")

    def syncs_at(self, r: int) -> bool:
        """Whether round ``r`` ends in a sync."""
        return r < self.warmup_rounds or (r - self.warmup_rounds + 1) % self.sync_every == 0

    def round_sync(self, fed, state):
        if not self.syncs_at(_round_index(fed, state)):
            return state
        return FedAvgSync.round_sync(self, fed, state)

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        # steady-state amortised (post-warmup) cost
        return super().bytes_per_round(cfg, params, opt) // self.sync_every


@dataclasses.dataclass(frozen=True)
class PerStepGradAvg(SyncStrategy):
    """The paper's distributed-GAN baseline (§3.2): the gradients are
    averaged over every agent at every step, so the agents stay identical
    and move as one."""

    sync_dtype: Any = None
    name = "distributed"

    def grad_hook(self, fed, grad_disc, grad_gen, state):
        w = fed._w(state["step"].device)
        return (collectives.average_agents(grad_disc, w, sync_dtype=self.sync_dtype),
                collectives.average_agents(grad_gen, w, sync_dtype=self.sync_dtype))

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        wire = collectives.sync_bytes(params, sync_dtype=self.sync_dtype)
        return 2 * wire * cfg.sync_interval


@dataclasses.dataclass(frozen=True)
class Hierarchical(FedAvgSync):
    """Two-tier sync for a (P, A) grid of pods: the weighted average within
    each pod every ``intra_interval`` steps, the full average every K."""

    intra_interval: int = 0
    name = "hierarchical"

    def validate(self, cfg):
        super().validate(cfg)
        if not self.intra_interval or cfg.sync_interval % self.intra_interval:
            raise ValueError("hierarchical sync needs intra_interval | "
                             "sync_interval (got "
                             f"{self.intra_interval} vs {cfg.sync_interval})")

    def segment_sync(self, fed, state):
        new = dict(state)
        new["params"] = collectives.average_intra_pod(
            state["params"], fed._w(state["step"].device))
        return new

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        full = FedAvgSync.bytes_per_round(self, cfg, params, opt)
        n_segs = cfg.sync_interval // self.intra_interval
        # the segment sync moves the whole params tree at its storage type
        # (no sync_dtype cast, no optimizer state) inside a pod
        intra = 2 * collectives.sync_bytes(params)
        return full + n_segs * intra


_ROBUST_SECURE_ERR = (
    "robust aggregation needs the individual per-agent values a secure "
    "sum hides (order statistics cannot run on a masked total); drop "
    "secure_agg or fall back to strategy='fedgan'")


@dataclasses.dataclass(frozen=True)
class TrimmedMeanSync(FedAvgSync):
    """Byzantine-robust FedAvg: per coordinate, drop the ``trim`` smallest
    and largest of the B agent values and average the rest.  f <= trim
    corrupted agents (sign-flipped, x100-scaled, NaN) cannot move the
    aggregate outside the honest agents' range.  The dataset-size weights
    are ignored (a poisoned agent could otherwise buy influence through a
    claimed dataset size).  With a codec the reduce runs on the decoded
    wire images of the composed pipeline; no fedavg launches."""

    trim: int = 1
    name = "trimmed_mean"

    def validate(self, cfg):
        super().validate(cfg)
        if self.trim < 1:
            raise ValueError(f"trim must be >= 1, got {self.trim}")
        if cfg.num_agents <= 2 * self.trim:
            raise ValueError(
                f"trimmed_mean needs num_agents > 2*trim = {2 * self.trim}, "
                f"got {cfg.num_agents} — no honest values would survive")
        if self.secure_agg is not None:
            raise ValueError(_ROBUST_SECURE_ERR)

    def sync_reduce(self):
        return collectives.make_robust_reduce("trimmed_mean", trim=self.trim)


@dataclasses.dataclass(frozen=True)
class CoordinateMedianSync(FedAvgSync):
    """Byzantine-robust FedAvg through the per-coordinate lower median:
    breakdown point f < B/2, at the cost of all magnitude information.
    Weight-oblivious, like :class:`TrimmedMeanSync`."""

    name = "median"

    def validate(self, cfg):
        super().validate(cfg)
        if self.secure_agg is not None:
            raise ValueError(_ROBUST_SECURE_ERR)

    def sync_reduce(self):
        return collectives.make_robust_reduce("median")


def check_async_mergeable(strategy) -> None:
    """Refuse strategies whose sync cannot ride the async buffered merge.

    ``repro_torch.run.async_agg`` applies staleness-weighted parameter
    deltas (``theta_post - theta_dispatch``) as they arrive, so the server
    never sees a synchronous cohort; anything whose aggregation is not a
    plain weighted mean of the declared subtrees raises here rather than
    merging wrongly, each knob with its own message (the reference's)."""
    if isinstance(strategy, SubsampledFedAvg):
        raise ValueError(
            "subsampled participation draws its own per-round mask inside "
            "the traced sync; under asynchronous buffering the server "
            "already decides who contributes to each flush — drop "
            "SubsampledFedAvg and pass the schedule to the async driver")
    if getattr(strategy, "sync_reduce", None) is not None \
            and strategy.sync_reduce() is not None:
        raise ValueError(
            "a robust reduce is an order statistic over one synchronous "
            "cohort's values; an asynchronous buffer mixes deltas taken "
            "against different server versions, which voids the breakdown "
            "bound — run strategy='fedgan' or the per-round driver")
    if getattr(strategy, "secure_agg", None) is not None:
        raise ValueError(
            "secure_agg= pairwise masks only cancel when every cohort "
            "member's update is summed in one shot; an asynchronous "
            "buffer flushes partial sums, leaving pads uncancelled — "
            "drop secure_agg or use the per-round driver")
    if getattr(strategy, "codec", None) is not None:
        raise ValueError(
            "codec= residual feedback assumes every agent decodes the "
            "same aggregate each round; an asynchronous flush would "
            "replay stale payloads against a moved server — drop the "
            "codec for async runs")
    if getattr(strategy, "sync_dtype", None) is not None:
        raise ValueError(
            "sync_dtype= casts the wire image of a synchronous average; "
            "the asynchronous buffered merge applies host-side deltas and "
            "has no wire cast point — drop sync_dtype for async runs")
    if getattr(strategy, "average_opt_state", False):
        raise ValueError(
            "average_opt_state= needs one agent-stacked moment tensor to "
            "average; under asynchronous buffering each client's moments "
            "stay local between its own dispatches — drop it")
    if type(strategy) not in (FedAvgSync, PartialSharing):
        raise ValueError(
            f"asynchronous buffered aggregation supports plain FedAvgSync/"
            f"PartialSharing only; {strategy.name!r} schedules or "
            f"transforms its aggregation in ways a delta buffer cannot "
            f"replay — use the per-round driver for it")


STRATEGIES = {
    "fedgan": FedAvgSync,
    "distributed": PerStepGradAvg,
    "local_only": LocalOnly,
    "hierarchical": Hierarchical,
    "partial_sharing": PartialSharing,
    "ps_fedgan": PartialSharing,
    "subsampled": SubsampledFedAvg,
    "adaptive_k": AdaptiveK,
    "trimmed_mean": TrimmedMeanSync,
    "median": CoordinateMedianSync,
}


def get_strategy(name: str, **kwargs) -> SyncStrategy:
    """Instantiate a strategy by name (the CLI entry point)."""
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"known: {sorted(STRATEGIES)}") from None
    return cls(**kwargs)


def strategy_from_mode(mode: str, *, intra_interval: int = 0, sync_dtype=None,
                       average_opt_state: bool = False) -> SyncStrategy:
    """Resolve a legacy ``FedGANConfig.mode`` string (and its companion
    config fields) to the equivalent strategy."""
    if mode == "fedgan":
        return FedAvgSync(sync_dtype=sync_dtype, average_opt_state=average_opt_state)
    if mode == "distributed":
        return PerStepGradAvg(sync_dtype=sync_dtype)
    if mode == "local_only":
        return LocalOnly()
    if mode == "hierarchical":
        return Hierarchical(intra_interval=intra_interval, sync_dtype=sync_dtype,
                            average_opt_state=average_opt_state)
    raise ValueError(f"unknown mode {mode!r}")
