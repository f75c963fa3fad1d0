"""Virtual-client runtime: ``A_total`` clients on ``A_active`` device slots
(a port of ``repro.run.virtual``).

The dense driver keeps every agent on the device as a stacked ``(P, A)``
leaf, which caps the fleet at what device memory holds.  A real
cross-device fleet is far larger than one round's cohort, so this module
decouples the two sizes:

  * :class:`ClientStore` keeps the clients' state on the host (numpy rows:
    params, Adam moments, per-client error-feedback residuals),
    copy-on-write over the shared Algorithm-1 init template, so a fleet
    that has touched k clients holds k rows;
  * a ``ParticipationSchedule`` picks each round's cohort (seeded and
    stateless, so a resumed run replays the same cohorts), and
    :class:`repro_torch.data.FleetRounds` assembles that cohort's round,
    salted by global client id, on the host;
  * :class:`VirtualClientDriver` runs the port's ``FedGAN.round`` on the
    ``(P, A_active)`` slot grid, never on ``A_total``, and pages cohort
    state between the store and the slots around it.  Swaps are
    diff-based (a client keeps its slot while it stays in the cohort; the
    identity schedule swaps nothing).  On the card the next cohort's rows
    and batches go through pinned host buffers with ``non_blocking``
    copies on a side stream while the current round runs, and the evicted
    rows come back the same way, waited on (an event) only when the store
    needs them, after the next round was dispatched;
  * :class:`StragglerPolicy` ``mode="defer"`` lets a planted-late cohort
    member's delta merge into a later round's average with the staleness
    decay ``gamma**s`` instead of blocking, and planted drops revert to
    their pre-round row.  That merge is the eq. (2) weighted sum through
    the fedavg kernel (``fedavg_tree``) plus the decayed late deltas.

With ``A_total == A_active`` and the identity schedule the fleet is the
dense ``RoundDriver`` stream run bit for bit: params, optimizer state,
error-feedback residuals and metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import strategies as sync_strategies
from repro_torch.core.participation import ParticipationSchedule
from repro_torch.data.federated import (FleetRounds, _PinnedUpload, round_key_schedule,
                                        stream_key_schedule)
from repro_torch.kernels.fedavg.ops import fedavg_tree
from repro_torch.run.driver import RunResult, _Table, check_dp_sample_rate
from repro_torch.run.graph import metric_row
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# entries every FedGAN state carries; strategies declare the rest through
# SyncStrategy.state_axes()
_BASE_AXES = {"params": "client", "opt_g": "client", "opt_d": "client",
              "step": "shared"}


def state_axes(fed, state) -> dict:
    """Per-entry paging axis ("client" or "shared") of a round state."""
    axes = dict(_BASE_AXES)
    axes.update(fed.cfg.resolve_strategy().state_axes())
    unknown = sorted(set(state) - set(axes))
    if unknown:
        raise ValueError(
            f"strategy {fed.cfg.resolve_strategy().name!r} carries round-"
            f"state entries {unknown} without declaring them per-client or "
            "shared in SyncStrategy.state_axes(); the ClientStore cannot "
            "page state it cannot classify")
    bad = sorted(k for k, v in axes.items() if v not in ("client", "shared"))
    if bad:
        raise ValueError(f"state_axes() values must be 'client' or "
                         f"'shared'; got {[axes[k] for k in bad]} for {bad}")
    return axes


def _client_keys(axes) -> tuple:
    return tuple(sorted(k for k, ax in axes.items() if ax == "client"))


def init_generators(rng):
    """``(data_rng, init_generator)`` of a run's root ``rng`` (an int seed
    or a ``prng`` key): ``data_rng, init_rng = split(rng)`` as the
    reference derives them, and a fresh host ``torch.Generator`` seeded
    from ``init_rng``'s words for every init draw."""
    data_rng, init_rng = prng.split(prng.as_key(rng))
    return data_rng, lambda: torch.Generator().manual_seed(prng.key_seed(init_rng))


class ClientStore:
    """Host-side fleet state: one numpy row per materialized client,
    copy-on-write over the shared init template.

    A row is the client-axis slice of the round state, ``{"params", "opt_g",
    "opt_d"}`` plus per-client strategy entries (the uplink EF residual),
    with the leading ``(P, A)`` dims stripped.  Algorithm 1 starts every
    client from the same point, so a client that never took part reads
    ``template`` and costs no memory; ``put`` stores a private row."""

    def __init__(self, template, n_total: int):
        self.template = template
        self.n_total = int(n_total)
        self._rows: dict[int, Any] = {}

    @classmethod
    def from_fed(cls, fed, gen: torch.Generator, n_total: int) -> "ClientStore":
        """The template from a (1, 1) slot-view init on the host, drawn
        from ``gen`` as the dense init draws, so template rows equal a
        fresh ``fed.init_state`` slot from an equal generator bit for
        bit."""
        fed1 = dataclasses.replace(fed, cfg=dataclasses.replace(fed.cfg, agent_grid=(1, 1)),
                                   weights=None)
        tiny = fed1.init_state(gen, device="cpu")
        axes = state_axes(fed, tiny)
        template = {k: tree_map(lambda x: x[0, 0].numpy().copy(), tiny[k])
                    for k in _client_keys(axes)}
        return cls(template, n_total)

    @property
    def materialized(self) -> int:
        """Rows holding private state (the copy-on-write high-water mark)."""
        return len(self._rows)

    def client_ids(self):
        return sorted(self._rows)

    def row(self, cid: int):
        """Client ``cid``'s row; the shared template if it has none, so a
        caller never writes into a row it reads."""
        return self._rows.get(int(cid), self.template)

    def put(self, cid: int, row) -> None:
        if not 0 <= int(cid) < self.n_total:
            raise ValueError(f"client id {cid} outside fleet [0, {self.n_total})")
        self._rows[int(cid)] = row

    def gather(self, cids, out=None):
        """Stack the rows of ``cids`` into a ``(len(cids), ...)`` numpy
        tree, or into the leading rows of ``out`` (a tree of numpy arrays
        with room for them, e.g. views of pinned buffers)."""
        rows = [self.row(c) for c in cids]
        treedef = tree_flatten(rows[0])[1]
        cols = zip(*(tree_leaves(r) for r in rows))
        if out is None:
            return tree_unflatten(treedef, [np.stack(c) for c in cols])
        outs = tree_leaves(out)
        for o, c in zip(outs, cols):
            np.stack(c, out=o[:len(cids)])
        return out

    def scatter(self, cids, stacked) -> None:
        """Write back one private row per client from a ``(len(cids),
        ...)`` stacked numpy tree, each row copied, so no row aliases
        ``stacked`` or another row."""
        leaves, treedef = tree_flatten(stacked)
        for j, c in enumerate(cids):
            self.put(c, tree_unflatten(treedef, [x[j].copy() for x in leaves]))


def plan_swap(slot_clients, next_cohort):
    """Diff-based slot assignment: clients staying in the cohort keep
    their slot; leavers' slots go to entrants in order.  Returns
    ``(new_slot_clients, evicted_slots, entering_ids)``, both lists empty
    when the cohort is unchanged."""
    nxt = set(int(c) for c in next_cohort)
    cur = set(int(c) for c in slot_clients)
    evicted = [j for j, c in enumerate(slot_clients) if int(c) not in nxt]
    entering = [int(c) for c in next_cohort if int(c) not in cur]
    new = [int(c) for c in slot_clients]
    for j, c in zip(evicted, entering):
        new[j] = c
    return new, evicted, entering


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """What to do with planted-late cohort members.

    ``"block"`` (default): the round waits for everyone; late is just slow,
    only explicit ``"drop"`` faults are excluded (and renormalised away).
    ``"defer"``: a late member's delta ``theta_post - theta_pre`` is held
    on the host and merged into the round it arrives in with weight
    ``decay ** staleness`` (staleness in rounds, >= 1); deltas older than
    ``max_staleness`` are discarded."""

    mode: str = "block"
    decay: float = 0.5
    max_staleness: int = 2

    def validate(self) -> None:
        if self.mode not in ("block", "defer"):
            raise ValueError(f"straggler mode must be 'block' or 'defer', "
                             f"got {self.mode!r}")
        if not 0.0 <= self.decay <= 1.0:
            raise ValueError(f"staleness decay must be in [0, 1], got {self.decay}")
        if self.max_staleness < 1:
            raise ValueError(f"max_staleness must be >= 1, got {self.max_staleness}")


def staleness_scale(staleness: int, policy: StragglerPolicy) -> float:
    """One delta's staleness discount: ``decay ** staleness``, exactly 0
    past ``max_staleness``.  Shared by the deferred merge and the async
    buffer (``repro_torch.run.async_agg``)."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if staleness > policy.max_staleness:
        return 0.0
    return float(policy.decay ** staleness)


def staleness_weights(staleness, policy: StragglerPolicy, base=None) -> np.ndarray:
    """Normalised float32 merge weights of one async buffer flush:
    ``base_i * decay**staleness_i`` (0 past ``max_staleness``; ``base``
    the optional §3.1 dataset-size shares), divided by their sum in
    float64; an all-expired buffer gives all zeros, never NaN."""
    s = [int(x) for x in staleness]
    raw = np.array([staleness_scale(x, policy) for x in s], np.float64)
    if base is not None:
        b = np.asarray(base, np.float64)
        if b.shape != raw.shape:
            raise ValueError(f"base weights shape {b.shape} != "
                             f"staleness shape {raw.shape}")
        if not np.isfinite(b).all() or (b < 0).any():
            raise ValueError("base weights must be finite and >= 0")
        raw = raw * b
    tot = raw.sum()
    if tot > 0:
        raw = raw / tot
    return raw.astype(np.float32)


def _pad_bucket(items):
    """``items`` padded to the next power-of-two length by repeating its
    first element.  The pager sizes its pinned buffers by this length, so
    a run keeps O(log slots) of them whatever its swap sizes."""
    if not items:
        return items
    n = 1
    while n < len(items):
        n *= 2
    return list(items) + [items[0]] * (n - len(items))


class _RowPager:
    """Moves stacked slot rows between the host and ``device``.  On the
    card both directions go through pinned buffers, one per direction and
    bucket (``_pad_bucket``), with ``non_blocking`` copies and an event:
    uploads on a side stream, downloads on the compute stream after the
    gather.  On the CPU rows are converted in place of a copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._up: dict = {}      # bucket -> [pinned tree, event of its last copy]
        self._down: dict = {}    # bucket -> pinned tree

    @staticmethod
    def _pinned(like, cap):
        return tree_map(lambda x: torch.empty((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                                              pin_memory=True), like)

    def upload(self, store: ClientStore, cids):
        """Start copying the rows of ``cids`` to the device: a pending
        ``(tree of (n, ...) device tensors, event)``."""
        if not self.cuda:
            return tree_map(torch.from_numpy, store.gather(cids)), None
        n, cap = len(cids), len(_pad_bucket(list(cids)))
        entry = self._up.get(cap)
        if entry is None:
            like = tree_map(lambda x: torch.from_numpy(np.asarray(x)[None]),
                            store.row(cids[0]))
            entry = self._up[cap] = [self._pinned(like, cap), None]
        elif entry[1] is not None:
            entry[1].synchronize()   # that buffer's last copy has landed
        pin = entry[0]
        store.gather(cids, out=tree_map(lambda p: p.numpy(), pin))
        with torch.cuda.stream(self.stream):
            dev = tree_map(lambda p: torch.empty((n,) + tuple(p.shape[1:]), dtype=p.dtype,
                                                 device=self.device).copy_(
                                                     p[:n], non_blocking=True), pin)
            event = torch.cuda.Event()
            event.record(self.stream)
        entry[1] = event
        return dev, event

    def take(self, pending):
        """The uploaded rows, usable on the current stream: it waits on the
        copy's event and each tensor is marked in use there."""
        dev, event = pending
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for x in tree_leaves(dev):
                x.record_stream(compute)
        return dev

    def download(self, gathered):
        """Start copying ``gathered`` ((n, ...) device tensors) to the
        host: a pending ``(tree of numpy arrays, event)``.  The arrays are
        views of a pinned buffer that the next download of the same bucket
        overwrites, valid once the event has completed."""
        if not self.cuda:
            return tree_map(lambda x: x.numpy(), gathered), None
        n = tree_leaves(gathered)[0].shape[0]
        cap = len(_pad_bucket(list(range(n))))
        pin = self._down.get(cap)
        if pin is None:
            pin = self._down[cap] = self._pinned(gathered, cap)
        tree_map(lambda p, x: p[:n].copy_(x, non_blocking=True), pin, gathered)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return tree_map(lambda p: p[:n].numpy(), pin), event


def _wait(pending):
    rows, event = pending
    if event is not None:
        event.synchronize()
    return rows


def _put_rows(x, pp, aa, rows):
    """``x`` with its slots ``(pp, aa)`` set to ``rows``, out of place
    (a synced leaf may be a stride-0 view over the grid)."""
    y = x.clone(memory_format=torch.contiguous_format)
    y[pp, aa] = rows.to(y.dtype)
    return y


@dataclasses.dataclass
class VirtualClientDriver:
    """Drives ``n_rounds`` FedGAN rounds over a fleet of
    ``fleet.num_clients`` virtual clients on ``P * A_active`` device slots
    (``fed.cfg.agent_grid == (P, A_active)``) on ``device``.

    ``faults`` is the fault-injection hook of the straggler tests:
    ``faults(round_idx, slot_clients) -> {client_id: "drop" | "late" |
    "late:<k>"}``.  Fault handling, and any deferred merge, runs on a split
    path (K local steps, then the host-planned merge); without ``faults``
    every round is the same ``FedGAN.round`` call the dense driver makes.
    ``weighting`` is ``"uniform"`` (the dense default) or ``"dataset"``
    (§3.1 ``|R_i| / sum_cohort |R_j|`` from the fleet's shard sizes, in
    float32 as ``dataset_weights`` makes them).  Under DP-SGD the driver
    refuses an accountant ``sample_rate`` below the fleet's
    (``check_dp_sample_rate``) and draws each round's noise from that
    round's generator of ``round_key_schedule``, as the dense stream
    does."""

    fed: Any
    fleet: FleetRounds
    n_rounds: int
    schedule: ParticipationSchedule = ParticipationSchedule()
    straggler: StragglerPolicy = StragglerPolicy()
    faults: Callable | None = None
    weighting: str = "uniform"
    log_every: int = 1
    eval_every: int = 0
    eval_hooks: Sequence[Callable] = ()
    ckpt_every: int = 0
    ckpt_dir: str = ""
    verbose: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        P, A = self.fed.cfg.agent_grid
        self._grid = (P, A)
        self._slots = P * A
        if tuple(self.fleet.slot_grid) != (P, A):
            raise ValueError(f"fleet slot_grid {self.fleet.slot_grid} != "
                             f"fed agent_grid {(P, A)}")
        self.n_total = self.fleet.num_clients
        self.schedule.validate(self.n_total)
        self.straggler.validate()
        if self.weighting not in ("uniform", "dataset"):
            raise ValueError(f"weighting must be 'uniform' or 'dataset', "
                             f"got {self.weighting!r}")
        if self.fed.weights is not None:
            raise ValueError(
                "FedGAN.weights is shaped for a fixed (P, A) grid; under "
                "the virtual scheduler per-round cohort weights come from "
                "weighting='uniform'|'dataset' instead")
        strat = self.fed.cfg.resolve_strategy()
        if getattr(strat, "secure_agg", None) is not None \
                and self.n_total > self._slots:
            raise ValueError(
                "secure_agg= needs every pair's both mask halves on the "
                "wire; a sampled cohort (A_active < A_total) leaves the "
                "absent clients' pad halves uncancelled — run the full "
                "fleet on device (A_total == A_active) or drop secure_agg")
        if self.faults is not None or self.straggler.mode == "defer":
            self._check_mergeable(strat)
        if self.faults is not None and self.ckpt_every:
            raise ValueError(
                "checkpointing a fault-injection run is not supported: "
                "in-flight late deltas are host-side driver state a "
                "checkpoint does not capture")
        if self.eval_every and not self.eval_hooks:
            raise ValueError("eval_every is set but eval_hooks is empty")
        self.device = resolve_device(self.device)
        self.store: ClientStore | None = None
        self.slot_clients: list[int] | None = None
        self._pager = self._upload = None
        self._evicting = None    # (client ids, pending download) not yet in the store

    def _check_mergeable(self, strat):
        """The deferred/fault merge recomputes the round average with
        per-round weights; that algebra is plain weighted FedAvg's alone.
        Anything else is refused rather than merged wrongly."""
        ok = type(strat) in (sync_strategies.FedAvgSync, sync_strategies.PartialSharing)
        if not ok or strat.codec is not None or strat.sync_dtype is not None \
                or strat.secure_agg is not None \
                or strat.sync_reduce() is not None or strat.average_opt_state:
            raise ValueError(
                f"straggler-tolerant merge supports plain FedAvgSync/"
                f"PartialSharing only (no codec/sync_dtype/secure_agg/"
                f"robust reduce/average_opt_state): a deferred delta "
                f"cannot be replayed through {strat.name!r}'s sync — use "
                f"StragglerPolicy(mode='block') without faults, or "
                f"simplify the strategy")

    # ------------------------------------------------------------------
    def cohort(self, round_idx: int) -> np.ndarray:
        return self.schedule.cohort(round_idx, self.n_total, self._slots)

    def _weights_row(self, slot_clients) -> np.ndarray:
        """Nominal per-slot float32 weight shares (sum 1) of this cohort."""
        if self.weighting == "uniform":
            return np.full(self._slots, 1.0 / self._slots, np.float32)
        sizes = self.fleet.client_sizes()[np.asarray(slot_clients, np.int64)]
        sizes = sizes.astype(np.float32)
        return sizes / sizes.sum()

    def _fed_for(self, slot_clients):
        """The FedGAN of a round: ``self.fed``, or under dataset weighting
        a copy carrying this cohort's (P, A) weights."""
        if self.weighting == "uniform":
            return self.fed
        w = torch.from_numpy(self._weights_row(slot_clients).reshape(self._grid))
        return dataclasses.replace(self.fed, weights=self._to_device(w))

    def _local_fed(self, fed):
        """The LocalOnly twin: K local steps, no sync, the training half of
        the split fault/merge path."""
        cfg = dataclasses.replace(fed.cfg, strategy=sync_strategies.LocalOnly(), mode="",
                                  sync_dtype=None, average_opt_state=False)
        return dataclasses.replace(fed, cfg=cfg)

    def _merge(self, state, w_on, extra, recv):
        """The aggregation half: ``theta_bar = sum_i w_on[i] theta_i +
        extra`` (the decayed late deltas) per synced leaf, the sum through
        the fedavg kernel, broadcast to the slots in ``recv`` (the on-time
        participants); everyone else keeps local values."""
        dev = self.device
        w = torch.from_numpy(w_on).to(dev)
        mask = torch.from_numpy(recv).to(dev)
        new = dict(state)
        params = dict(state["params"])
        for k in self.fed.cfg.resolve_strategy().subtrees:
            avg = fedavg_tree(w, state["params"][k])
            merged = tree_map(lambda x, a, e: (a + torch.from_numpy(e).to(dev, x.dtype)).expand(
                x.shape), state["params"][k], avg, extra[k])
            params[k] = sync_strategies._select(mask, merged, state["params"][k])
        new["params"] = params
        return new

    # -- paging --------------------------------------------------------
    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """A small host tensor on the device without a host wait: on the
        card through pinned memory and a ``non_blocking`` copy (a pageable
        copy would wait for the round in flight)."""
        if self.device.type != "cuda":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)

    def _coords(self, slots):
        idx = self._to_device(torch.tensor([int(j) for j in slots], dtype=torch.int64))
        A = self._grid[1]
        return idx // A, idx % A

    def _download_slots(self, state, slots, axes):
        """Start copying the client-axis rows in ``slots`` to the host: a
        pending ``(stacked numpy tree, event)`` (see ``_RowPager``)."""
        pp, aa = self._coords(slots)
        gathered = {k: tree_map(lambda x: x[pp, aa], state[k]) for k in _client_keys(axes)}
        return self._pager.download(gathered)

    def _fetch_slots(self, state, slots, axes):
        """The client-axis rows in ``slots`` on the host now: a stacked
        numpy tree of private copies."""
        return tree_map(np.copy, _wait(self._download_slots(state, slots, axes)))

    def _apply_swap(self, state, slots, staged, axes):
        """Write staged rows (device tensors, leading len(slots)) into
        their slots."""
        pp, aa = self._coords(slots)
        new = dict(state)
        for k in _client_keys(axes):
            if k in staged:
                new[k] = tree_map(lambda x, r: _put_rows(x, pp, aa, r), state[k], staged[k])
        return new

    def _finish_evict(self):
        """Land the last swap's evicted rows in the store (waits on their
        download's event)."""
        if self._evicting is not None:
            cids, pending = self._evicting
            self._evicting = None
            self.store.scatter(cids, _wait(pending))

    def flush(self, state) -> None:
        """Persist every resident slot row into the store (end of run,
        checkpoint boundary), so the host fleet view is complete."""
        self._finish_evict()
        axes = state_axes(self.fed, state)
        rows = _wait(self._download_slots(state, list(range(self._slots)), axes))
        self.store.scatter(self.slot_clients, rows)

    def _batches(self, key, slot_clients):
        """A pending round of ``slot_clients``: on the card assembled into
        pinned memory and uploaded on a side stream."""
        if self._upload is None:
            return self.fleet.round_batches(key, slot_clients)
        return self._upload.launch(key, slot_clients)

    def _take_batches(self, pending):
        if self._upload is None:
            return pending
        return self._upload.take(pending)

    # ------------------------------------------------------------------
    def run(self, rng, state=None, *, start_round: int = 0, store=None,
            slot_clients=None) -> RunResult:
        """Run rounds ``start_round .. n_rounds - 1``.  ``rng`` (an int seed
        or a ``prng`` key) is the run's root: ``data_rng, init_rng =
        split(rng)`` as the reference derives them; the round keys are
        ``stream_key_schedule(data_rng)`` and the init draws come from a
        generator seeded from ``init_rng`` (``init_generators``).  A
        resumed run (same ``rng``, restored ``state``/``store``/
        ``slot_clients``, ``start_round`` from the checkpoint) replays the
        uninterrupted run's cohorts and batches.  The timings add to the
        dense driver's the fleet's counts and ``paging_s``: the host
        seconds a round spends paging rows (landing the evicted rows in
        the store, staging the entering ones, swapping them into their
        slots), part of ``round_gap_s``."""
        if not 0 <= start_round < self.n_rounds:
            raise ValueError(f"start_round {start_round} outside "
                             f"[0, {self.n_rounds})")
        dev = self.device
        dp = self.fed.cfg.dp
        if dp is not None:
            check_dp_sample_rate(dp, self.fleet)
        data_rng, init_gen = init_generators(rng)
        if state is None:
            state = self.fed.init_state(init_gen(), device=dev)
            store = ClientStore.from_fed(self.fed, init_gen(), self.n_total)
        if store is not None:
            self.store = store
        if self.store is None:
            raise ValueError("pass store= (a ClientStore) when resuming "
                             "from an explicit state")
        self._pager = _RowPager(dev)
        self._upload = _PinnedUpload(self.fleet, 2, dev) if dev.type == "cuda" else None
        self._evicting = None
        axes = state_axes(self.fed, state)
        keys = stream_key_schedule(data_rng, self.n_rounds)
        gens = (round_key_schedule(prng.key_seed(data_rng), self.n_rounds, dev)
                if self.fed.cfg.dp_noise else [None] * self.n_rounds)

        # initial cohort: fresh slots are interchangeable (every client is
        # still the template); a resumed run swaps from the checkpointed
        # assignment to this round's cohort
        first = self.cohort(start_round)
        if slot_clients is None:
            self.slot_clients = [int(c) for c in first]
        else:
            self.slot_clients, evicted, entering = plan_swap(slot_clients, first)
            if evicted:
                rows = self._fetch_slots(state, evicted, axes)
                self.store.scatter([slot_clients[j] for j in evicted], rows)
                state = self._apply_swap(state, evicted, self._pager.take(
                    self._pager.upload(self.store, entering)), axes)

        self._evals = []
        n_run = self.n_rounds - start_round
        table = _Table(n_run)
        pending = []   # (client_id, delta_row, submit_round, arrival_round, w_share)
        stats = {"swapped_rows": 0, "late": 0, "dropped": 0,
                 "merged_deltas": 0, "expired_deltas": 0}
        gap = paging = 0.0
        t0 = time.perf_counter()
        t_host = time.perf_counter()

        batches = self._batches(keys[start_round], self.slot_clients)
        for i, r in enumerate(range(start_round, self.n_rounds)):
            b, _seeds = self._take_batches(batches)
            if self.faults is None:
                gap += time.perf_counter() - t_host
                state, metrics = self._fed_for(self.slot_clients).round(state, b, gens[r])
                t_host = time.perf_counter()
            else:
                self._finish_evict()   # the fault path downloads rows itself
                state, metrics, pending = self._fault_round(
                    r, state, b, gens[r], pending, axes, stats)
            keys_m = sorted(metrics)
            table.put(i, keys_m, metric_row(metrics, keys_m))
            # the previous swap's evicted rows land while this round runs
            t_page = time.perf_counter()
            self._finish_evict()

            # stage the next round's batches and entering rows while this
            # round's result is in flight
            nxt = None
            if r + 1 < self.n_rounds:
                new_slots, evicted, entering = plan_swap(self.slot_clients, self.cohort(r + 1))
                staged = self._pager.upload(self.store, entering) if entering else None
                paging += time.perf_counter() - t_page
                batches = self._batches(keys[r + 1], new_slots)
                nxt = (new_slots, evicted, staged)

            self._boundaries(state, r, i, table)

            if nxt is not None:
                new_slots, evicted, staged = nxt
                t_page = time.perf_counter()
                if evicted:
                    self._evicting = ([self.slot_clients[j] for j in evicted],
                                      self._download_slots(state, evicted, axes))
                    state = self._apply_swap(state, evicted, self._pager.take(staged), axes)
                    stats["swapped_rows"] += len(evicted)
                paging += time.perf_counter() - t_page
                self.slot_clients = new_slots

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        gap += time.perf_counter() - t_host
        total = time.perf_counter() - t0
        self.flush(state)
        K = self.fed.cfg.sync_interval
        timings = {
            "total_s": total,
            "steps_per_s": n_run * K / max(total, 1e-9),
            "rounds_per_s": n_run / max(total, 1e-9),
            "round_gap_s": gap / max(n_run, 1),
            "paging_s": paging / max(n_run, 1),
            "data_kind": "virtual",
            "a_total": self.n_total,
            "a_active": self._slots,
            "store_rows": self.store.materialized,
            **stats,
        }
        if dp is not None:
            timings["dp_epsilon"] = dp.epsilon(self.n_rounds * K)
        return RunResult(self.fed, state, table.history(), self._evals, timings)

    # -- straggler / fault path ----------------------------------------
    def _parse_fault(self, kind: str) -> tuple[str, int]:
        if kind == "drop":
            return "drop", 0
        if kind == "late":
            return "late", 1
        if kind.startswith("late:"):
            return "late", int(kind.split(":", 1)[1])
        raise ValueError(f"unknown fault {kind!r}; use 'drop', 'late' or "
                         "'late:<rounds>'")

    def _fault_round(self, r, state, b, gen, pending, axes, stats):
        """One round on the split path: K local steps (no sync), then the
        merge that excludes drops, defers late deltas and folds in pending
        ones.  The deltas and their sum ``extra`` stay numpy on the host,
        as in the reference."""
        faults = {int(c): self._parse_fault(k)
                  for c, k in (self.faults(r, list(self.slot_clients)) or {}).items()}
        unknown = sorted(set(faults) - set(self.slot_clients))
        if unknown:
            raise ValueError(f"faults for clients {unknown} not in this "
                             f"round's cohort {self.slot_clients}")
        if faults and self.straggler.mode == "block":
            # blocking mode waits for the late: only drops are excluded
            faults = {c: (m, d) for c, (m, d) in faults.items() if m == "drop"}
        slot_of = {c: j for j, c in enumerate(self.slot_clients)}
        fault_slots = [slot_of[c] for c in sorted(faults)]
        pre = self._fetch_slots(state, fault_slots, axes) if fault_slots else None

        fed = self._fed_for(self.slot_clients)
        state, metrics = self._local_fed(fed).round(state, b, gen)

        w_row = self._weights_row(self.slot_clients)
        on_time = np.ones(self._slots, bool)
        post_fault = self._fetch_slots(state, fault_slots, axes) if fault_slots else None
        revert_slots = []
        for j, c in enumerate(sorted(faults)):
            mode, delay = faults[c]
            slot = fault_slots[j]
            on_time[slot] = False
            pre_row = tree_map(lambda x: x[j], pre)
            post_row = tree_map(lambda x: x[j], post_fault)
            if mode == "drop":
                stats["dropped"] += 1
                # never completed the round: its state is unchanged, on the
                # host and in its slot
                self.store.put(c, pre_row)
                revert_slots.append((slot, pre_row))
            else:
                stats["late"] += 1
                # trained, but its delta arrives `delay` rounds from now;
                # the client keeps its local state (it never receives
                # this round's broadcast)
                self.store.put(c, post_row)
                delta = tree_map(np.subtract, post_row["params"], pre_row["params"])
                pending.append((c, delta, r, r + delay, float(w_row[slot])))

        # drain the pending deltas that arrive this round
        strat = self.fed.cfg.resolve_strategy()
        extra = {k: tree_map(lambda x: np.zeros(tuple(x.shape[2:]), np.float32),
                             state["params"][k]) for k in strat.subtrees}
        still = []
        for (c, delta, submitted, arrival, w_share) in pending:
            if arrival > r:
                still.append((c, delta, submitted, arrival, w_share))
                continue
            staleness = r - submitted
            if staleness > self.straggler.max_staleness:
                stats["expired_deltas"] += 1
                continue
            stats["merged_deltas"] += 1
            scale = w_share * staleness_scale(staleness, self.straggler)
            for k in strat.subtrees:
                extra[k] = tree_map(lambda e, d: e + scale * d, extra[k], delta[k])

        if not on_time.any():
            raise ValueError(f"round {r}: every cohort member faulted — "
                             "no on-time participants to average")
        w_on = w_row * on_time
        w_on = (w_on / w_on.sum()).reshape(self._grid)
        state = self._merge(state, w_on, extra, on_time.reshape(self._grid))
        for slot, row in revert_slots:
            staged = tree_map(lambda x: torch.from_numpy(np.asarray(x)[None]).to(self.device),
                              row)
            state = self._apply_swap(state, [slot], staged, axes)
        return state, metrics, still

    # -- boundaries ----------------------------------------------------
    def _boundaries(self, state, r, i, table):
        K = self.fed.cfg.sync_interval
        last = r == self.n_rounds - 1
        if self.log_every and self.verbose and (r % self.log_every == 0 or last):
            m = table.round(i)
            head = self.slot_clients[:8]
            tail = "" if len(self.slot_clients) <= 8 else f" +{len(self.slot_clients) - 8}"
            print(f"round {r:5d}/{self.n_rounds} step {(r + 1) * K:6d} "
                  f"d_loss={m['d_loss']:.4f} g_loss={m['g_loss']:.4f} "
                  f"cohort={head}{tail}", flush=True)
        if self.eval_every and ((r + 1) % self.eval_every == 0 or last):
            scores = {}
            for hook in self.eval_hooks:
                scores.update(hook(self.fed, state, r))
            dp = self.fed.cfg.dp
            if dp is not None:
                scores["dp_epsilon"] = dp.epsilon((r + 1) * K)
            self._evals.append({"round": r, "step": (r + 1) * K, **scores})
        if self.ckpt_dir and self.ckpt_every and (r + 1) % self.ckpt_every == 0:
            self.save_fleet_checkpoint(self.ckpt_dir, state, r)

    # -- checkpointing -------------------------------------------------
    def save_fleet_checkpoint(self, directory: str, state, r: int) -> str:
        """One checkpoint holds the device slot state and the whole host
        fleet (materialized rows and template).  The cohorts need no state
        beyond (seed, round): the schedule is stateless, which is what
        makes a resume replay the cohort sequence."""
        self.flush(state)
        payload = {
            "device": state,
            "template": self.store.template,
            "fleet": {str(c): self.store._rows[c] for c in self.store.client_ids()},
        }
        meta = {
            "round": r,
            "K": self.fed.cfg.sync_interval,
            "virtual": True,
            "a_total": self.n_total,
            "slot_clients": [int(c) for c in self.slot_clients],
            "participation_seed": self.schedule.seed,
        }
        return save_checkpoint(directory, payload,
                               step=(r + 1) * self.fed.cfg.sync_interval, metadata=meta)


def _to_device(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def load_fleet_checkpoint(directory: str, *, step: int | None = None, device="cuda"):
    """Restore a virtual-client checkpoint: ``(state, store, slot_clients,
    next_round, metadata)``.  The fleet rows stay numpy on the host; only
    the ``(P, A_active)`` slot state goes to ``device``."""
    dev = resolve_device(device)
    payload, manifest = restore_checkpoint(directory, step=step, to_device=False)
    meta = manifest["metadata"]
    if not meta.get("virtual"):
        raise ValueError(f"{directory} is not a virtual-client checkpoint "
                         "(no fleet state); use restore_checkpoint")
    state = tree_map(lambda x: _to_device(x, dev), payload["device"])
    store = ClientStore(payload["template"], meta["a_total"])
    for cid, row in payload["fleet"].items():
        store.put(int(cid), row)
    return (state, store, list(meta["slot_clients"]), int(meta["round"]) + 1, meta)
