"""FedBuff-style async delta aggregation over the virtual-client fleet (a
port of ``repro.run.async_agg``).

The per-round fleet (:class:`repro_torch.run.virtual.VirtualClientDriver`)
blocks until the whole cohort reports.  This module runs the event-driven
contract instead (buffered async aggregation, arXiv 2106.06639):

  * the server keeps ``cohort`` clients in flight; each dispatch trains a
    single client from the current server parameters (the port's
    ``FedGAN.round`` on a ``(1, 1)`` LocalOnly twin) and its delta
    ``theta_post - theta_dispatch`` arrives after a seeded simulated
    latency (:class:`repro_torch.run.simclock.LatencyModel`);
  * arrivals land in a bounded buffer; once ``buffer_goal`` deltas are in,
    the flush merges them as ``theta + sum_i w_i delta_i`` through the
    fedavg kernel (``fedavg_tree``), weights ``decay ** staleness`` from
    the :class:`repro_torch.run.virtual.StragglerPolicy`, normalised per
    flush (``staleness_weights``); deltas older than ``max_staleness`` are
    dropped at arrival and counted;
  * a dispatch whose latency exceeds its budget times out and is retried
    with a fresh latency draw and a backed-off budget (``timeout *
    backoff**attempt``), then given up after ``max_retries``.

Everything runs on the :class:`repro_torch.run.simclock.SimClock` virtual
clock, so a seeded run replays bit for bit, journal and parameters, and
its journal is the reference's byte for byte apart from the
``params_digest`` fields (the schedule, the latencies and the event order
depend on the seeds alone).

With no latency model, no timeout and ``buffer_goal == cohort`` the
schedule is synchronous rounds, and the driver runs the fused per-round
fleet (:class:`VirtualClientDriver`), the dense ``RoundDriver`` run bit for
bit.  The buffered path takes plain FedAvg/PartialSharing only
(``repro_torch.core.strategies.check_async_mergeable``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import strategies as sync_strategies
from repro_torch.core.participation import ParticipationSchedule
from repro_torch.data.federated import FleetRounds
from repro_torch.kernels.fedavg.ops import fedavg_tree
from repro_torch.run.driver import RunResult
from repro_torch.run.simclock import EventJournal, LatencyModel, SimClock, params_digest
from repro_torch.run.virtual import (ClientStore, StragglerPolicy, VirtualClientDriver,
                                     init_generators, staleness_weights)
from repro_torch.tree import tree_map


def modeled_sync_makespan(schedule: ParticipationSchedule, latency: LatencyModel,
                          n_rounds: int, n_total: int, m: int) -> float:
    """Virtual-time cost of the blocking per-round schedule under the same
    latency model: every round waits for its slowest cohort member (the
    dispatch keys are the round index: a model of the sync driver, not a
    replay of the async one)."""
    t = 0.0
    for r in range(n_rounds):
        cohort = schedule.cohort(r, n_total, m)
        t += max(latency.draw(schedule, r, int(c), n_total) for c in cohort)
    return t


@dataclasses.dataclass
class _InFlight:
    """One outstanding dispatch."""
    client: int
    seq: int            # global dispatch counter (keys batches + latency)
    attempt: int        # retry attempt, 0-based
    version: int        # server version the client trained from
    delta: Any = None   # host numpy delta over the synced subtrees
    metrics: Any = None
    row: Any = None     # the client's post-training store row


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class AsyncAggDriver:
    """Event-driven buffered-async server over ``fleet.num_clients``
    virtual clients, ``fleet.cohort_size`` dispatches in flight, training
    on ``device``.

    ``n_rounds`` counts buffer flushes (server versions).  ``straggler``
    gives the staleness algebra (``decay``, ``max_staleness``); its
    ``mode`` is not read here.  ``latency=None`` with ``timeout=None``
    and a full-cohort ``buffer_goal`` selects the sync-equivalent fused
    path; anything else runs the buffered loop."""

    fed: Any
    fleet: FleetRounds
    n_rounds: int
    schedule: ParticipationSchedule = ParticipationSchedule()
    straggler: StragglerPolicy = StragglerPolicy(mode="defer")
    buffer_goal: int | None = None     # None -> cohort size
    latency: LatencyModel | None = None
    timeout: float | None = None
    max_retries: int = 2
    backoff: float = 2.0
    weighting: str = "uniform"
    log_every: int = 1
    verbose: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        P, A = self.fed.cfg.agent_grid
        if tuple(self.fleet.slot_grid) != (P, A):
            raise ValueError(f"fleet slot_grid {self.fleet.slot_grid} != "
                             f"fed agent_grid {(P, A)}")
        self.n_total = self.fleet.num_clients
        self.cohort_size = self.fleet.cohort_size
        self.schedule.validate(self.n_total)
        self.straggler.validate()
        if self.latency is not None:
            self.latency.validate()
        goal = self.cohort_size if self.buffer_goal is None else self.buffer_goal
        if not 1 <= goal <= self.cohort_size:
            raise ValueError(
                f"buffer_goal {goal} must be in [1, cohort={self.cohort_size}]"
                " — a goal above the in-flight count can never fill")
        self._goal = int(goal)
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {self.timeout}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.weighting not in ("uniform", "dataset"):
            raise ValueError(f"weighting must be 'uniform' or 'dataset', "
                             f"got {self.weighting!r}")
        self.sync_equivalent = (self.latency is None and self.timeout is None
                                and self._goal == self.cohort_size)
        if not self.sync_equivalent:
            # the buffered merge is a weighted delta sum; refuse whatever
            # sync that algebra cannot replay
            sync_strategies.check_async_mergeable(self.fed.cfg.resolve_strategy())
        self.device = resolve_device(self.device)
        self.journal = EventJournal()
        self.clock = SimClock()
        self.store: ClientStore | None = None

    # ------------------------------------------------------------------
    # degenerate path: the fused synchronous rounds, plus a journal
    # ------------------------------------------------------------------

    def _run_sync_equivalent(self, rng) -> RunResult:
        inner = VirtualClientDriver(self.fed, self.fleet, self.n_rounds,
                                    schedule=self.schedule, straggler=StragglerPolicy(),
                                    weighting=self.weighting, log_every=self.log_every,
                                    verbose=self.verbose, device=self.device)
        result = inner.run(rng)
        self.store = inner.store
        # the journal the buffered loop would write at zero latency: round
        # r dispatches, arrives and flushes at t = r
        for r in range(self.n_rounds):
            cohort = [int(c) for c in self.schedule.cohort(r, self.n_total,
                                                           self.cohort_size)]
            for j, c in enumerate(cohort):
                self.journal.append("dispatch", float(r), client=c,
                                    seq=r * self.cohort_size + j,
                                    attempt=0, version=r, latency=0.0)
            for c in cohort:
                self.journal.append("arrival", float(r), client=c, version=r, staleness=0)
            self.journal.append("flush", float(r), version=r, merged=len(cohort))
        self.journal.append("end", float(self.n_rounds - 1),
                            params_digest=params_digest(result.state["params"]))
        timings = dict(result.timings)
        timings.update(mode="sync_equivalent", makespan=0.0, flushes=self.n_rounds,
                       buffer_goal=self._goal, timeouts=0, retries=0, gave_up=0,
                       data_kind="async")
        return RunResult(result.fed, result.state, result.history, result.evals, timings)

    # ------------------------------------------------------------------
    # buffered path: per-client training on a (1, 1) LocalOnly twin
    # ------------------------------------------------------------------

    def _local1(self):
        cfg = dataclasses.replace(self.fed.cfg, agent_grid=(1, 1),
                                  strategy=sync_strategies.LocalOnly(), mode="",
                                  sync_dtype=None, average_opt_state=False)
        return dataclasses.replace(self.fed, cfg=cfg, weights=None)

    def _train(self, cid: int, seq: int, version: int):
        """Train one client from the current server params: its
        post-training store row, its host delta over the synced subtrees,
        and its scalar metrics.  The batches are salted by global client id
        and keyed by ``fold_in(data_rng, seq)``, so a replay draws them
        again."""
        dev = self.device
        row = self.store.row(cid)
        params = dict(row["params"])
        for k in self._subtrees:
            params[k] = self._server[k]
        lift = lambda t: tree_map(  # noqa: E731
            lambda x: torch.from_numpy(np.array(x, copy=True)[None, None]).to(dev), t)
        state1 = {"params": lift(params), "opt_g": lift(row["opt_g"]),
                  "opt_d": lift(row["opt_d"]),
                  "step": torch.tensor(self._step0 + version * self.fed.cfg.sync_interval,
                                       dtype=torch.int32, device=dev)}
        key = prng.fold_in(self._data_rng, seq)
        b, _seeds = self._fleet1.round_batches(key, [cid])
        b = tree_map(lambda x: x.to(dev), b)
        gen = (torch.Generator(device=dev).manual_seed(prng.key_seed(key))
               if self._fed1.cfg.dp_noise else None)
        state1, metrics = self._fed1.round(state1, b, gen)
        # one host fetch per dispatch: the simulator runs on the host
        row_post = {k: tree_map(lambda x: _host(x[0, 0]), state1[k])
                    for k in ("params", "opt_g", "opt_d")}
        delta = {k: tree_map(np.subtract, row_post["params"][k], self._server[k])
                 for k in self._subtrees}
        metrics = {k: float(torch.mean(v)) for k, v in metrics.items()}
        return row_post, delta, metrics

    def _next_client(self):
        """The next dispatchable client id from the schedule's wave stream,
        skipping ids already in flight."""
        scanned = 0
        while True:
            if self._wave_queue:
                cid = self._wave_queue.pop(0)
                if cid in self._in_flight_ids:
                    self._stats["skipped_busy"] += 1
                    scanned += 1
                    if scanned > 4 * self.n_total + self.cohort_size:
                        raise RuntimeError(
                            "dispatch stream scan did not find a free "
                            "client — in-flight bookkeeping is corrupt")
                    continue
                return cid
            wave = self.schedule.cohort(self._wave, self.n_total, self.cohort_size)
            self._wave += 1
            self._wave_queue = [int(c) for c in wave]

    def _dispatch(self, cid: int, attempt: int) -> None:
        seq = self._seq
        self._seq += 1
        self._in_flight_ids.add(cid)
        lat = (self.latency or LatencyModel()).draw(self.schedule, seq, cid,
                                                    self.n_total, attempt)
        t = self.clock.now
        self._stats["dispatches"] += 1
        self.journal.append("dispatch", t, client=cid, seq=seq, attempt=attempt,
                            version=self._version, latency=lat)
        budget = None if self.timeout is None else self.timeout * self.backoff ** attempt
        if budget is not None and lat > budget:
            # the reply will not make the budget: schedule the timeout
            # instead of the (discarded) arrival; the retry restarts the
            # client from whatever the server holds then
            self.clock.push(t + budget, "timeout", _InFlight(cid, seq, attempt, self._version))
            return
        fl = _InFlight(cid, seq, attempt, self._version)
        fl.row, fl.delta, fl.metrics = self._train(cid, seq, self._version)
        self.clock.push(t + lat, "arrival", fl)

    def _flush(self) -> None:
        entries = sorted(self._buffer, key=lambda e: e.seq)
        self._buffer = []
        stal = [self._version - e.version for e in entries]
        base = self._sizes[[e.client for e in entries]] if self.weighting == "dataset" else None
        w = staleness_weights(stal, self.straggler, base)
        dev = self.device
        w_dev = torch.from_numpy(w).to(dev)
        merged = {}
        for k in self._subtrees:
            deltas = tree_map(lambda *xs: torch.from_numpy(np.stack(xs)).to(dev),
                              *[e.delta[k] for e in entries])
            merged[k] = tree_map(lambda p, d: p + d, self._server_dev[k],
                                 fedavg_tree(w_dev, deltas))
        self._server_dev = merged
        self._server = tree_map(_host, merged)
        self._stats["merged_deltas"] += len(entries)
        self.journal.append(
            "flush", self.clock.now, version=self._version, merged=len(entries),
            clients=[e.client for e in entries], staleness=[int(s) for s in stal],
            weights=[float(x) for x in w], params_digest=params_digest(self._server))
        self._history.append({k: float(np.mean([e.metrics[k] for e in entries]))
                              for k in entries[0].metrics})
        self._version += 1
        if self.verbose and self.log_every and self._version % self.log_every == 0:
            m = self._history[-1]
            print(f"flush {self._version:4d}/{self.n_rounds} t={self.clock.now:8.2f} "
                  f"d_loss={m.get('d_loss', float('nan')):.4f} "
                  f"g_loss={m.get('g_loss', float('nan')):.4f}", flush=True)

    def _run_buffered(self, rng) -> RunResult:
        t0 = time.perf_counter()
        self._data_rng, init_gen = init_generators(rng)
        self.store = ClientStore.from_fed(self.fed, init_gen(), self.n_total)
        self._subtrees = tuple(self.fed.cfg.resolve_strategy().subtrees)
        self._server = {k: tree_map(np.copy, self.store.template["params"][k])
                        for k in self._subtrees}
        self._server_dev = tree_map(lambda x: torch.from_numpy(x.copy()).to(self.device),
                                    self._server)
        self._step0 = 0   # Algorithm 1's step counter at init
        self._fed1 = self._local1()
        self._fleet1 = dataclasses.replace(self.fleet, slot_grid=(1, 1))
        self._sizes = self.fleet.client_sizes().astype(np.float64)

        self._history, self._buffer = [], []
        self._version, self._seq, self._wave = 0, 0, 0
        self._wave_queue: list[int] = []
        self._in_flight_ids: set[int] = set()
        self._stats = {"dispatches": 0, "merged_deltas": 0, "expired_deltas": 0,
                       "timeouts": 0, "retries": 0, "gave_up": 0, "skipped_busy": 0}
        # a full fleet cycle of consecutive give-ups with no arrival means
        # no reply can ever make the budget: refuse, don't spin
        consecutive_gave_up = 0

        for _ in range(self.cohort_size):
            self._dispatch(self._next_client(), attempt=0)

        while self._version < self.n_rounds:
            if not len(self.clock):
                raise RuntimeError("event queue drained before the flush "
                                   "target — dispatch bookkeeping is corrupt")
            t, kind, fl = self.clock.pop()
            if kind == "timeout":
                self._in_flight_ids.discard(fl.client)
                self._stats["timeouts"] += 1
                self.journal.append("timeout", t, client=fl.client, seq=fl.seq,
                                    attempt=fl.attempt)
                if fl.attempt + 1 <= self.max_retries:
                    self._stats["retries"] += 1
                    self.journal.append("retry", t, client=fl.client, attempt=fl.attempt + 1)
                    self._dispatch(fl.client, fl.attempt + 1)
                else:
                    self._stats["gave_up"] += 1
                    consecutive_gave_up += 1
                    self.journal.append("gave_up", t, client=fl.client,
                                        attempts=fl.attempt + 1)
                    if consecutive_gave_up >= self.n_total:
                        raise ValueError(
                            f"async run starved: {consecutive_gave_up} "
                            "consecutive dispatches exhausted their retry "
                            "budgets with no arrival — the timeout "
                            f"({self.timeout}) is below every achievable "
                            "latency; raise it, the backoff, or max_retries")
                    self._dispatch(self._next_client(), attempt=0)
                continue
            # arrival
            consecutive_gave_up = 0
            self._in_flight_ids.discard(fl.client)
            self.store.put(fl.client, fl.row)
            staleness = self._version - fl.version
            if staleness > self.straggler.max_staleness:
                self._stats["expired_deltas"] += 1
                self.journal.append("expired", t, client=fl.client, seq=fl.seq,
                                    staleness=staleness)
            else:
                self._buffer.append(fl)
                self.journal.append("arrival", t, client=fl.client, seq=fl.seq,
                                    version=fl.version, staleness=staleness)
                if len(self._buffer) >= self._goal:
                    self._flush()
            if self._version < self.n_rounds:
                self._dispatch(self._next_client(), attempt=0)

        makespan = self.clock.now
        self.journal.append("end", makespan, in_flight=len(self.clock),
                            buffered=len(self._buffer),
                            params_digest=params_digest(self._server))
        total = time.perf_counter() - t0
        timings = {
            "total_s": total,
            "rounds_per_s": self.n_rounds / max(total, 1e-9),
            "makespan": makespan,
            "flushes": self._version,
            "buffer_goal": self._goal,
            "mode": "buffered",
            "data_kind": "async",
            "a_total": self.n_total,
            "a_active": self.cohort_size,
            "store_rows": self.store.materialized,
            **self._stats,
        }
        state = {"params": self._server, "version": self._version}
        return RunResult(self.fed, state, self._history, [], timings)

    # ------------------------------------------------------------------
    def run(self, rng) -> RunResult:
        """Run from the root ``rng`` (an int seed or a ``prng`` key; split
        as the per-round fleet splits it), with a fresh journal and clock:
        running one driver again does not accumulate events."""
        self.journal = EventJournal()
        self.clock = SimClock()
        if self.sync_equivalent:
            return self._run_sync_equivalent(rng)
        return self._run_buffered(rng)
