"""Deterministic virtual-time simulation for the async runtime (a port of
``repro.run.simclock``).

Every scheduling decision of the async server (``repro_torch.run.async_agg``)
is driven by virtual time, never the wall clock, so an async schedule is a
pure function of its seeds and replays bit for bit:

  * :class:`SimClock`: a heap of events ordered by ``(time, seq)``; the
    push sequence number breaks ties, so simultaneous events fire in a
    deterministic order;
  * :class:`LatencyModel`: a client's round-trip latency as a pure function
    of ``(schedule.seed, dispatch_seq, client, attempt)``, drawn through
    ``ParticipationSchedule.arrival_uniforms`` (the reference's Threefry
    bits, so the port's latencies are the reference's);
  * :class:`EventJournal`: an append-only record of every dispatch,
    arrival, timeout, retry and flush, serialized canonically (sorted keys,
    no whitespace, shortest round-trip floats), so two runs of one seed are
    byte-identical, and the port's journal is the reference's byte for byte
    apart from the ``params_digest`` fields.

``python -m repro_torch.run.simclock --seed 7 --out journal.jsonl`` runs a
self-contained straggler simulation (a small quadratic GAN fleet, on the
card unless ``--device cpu``) and writes the journal; run it twice and
``cmp`` the outputs.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.participation import ParticipationSchedule


class SimClock:
    """Virtual-time event queue.  Events are ``(time, seq, kind, payload)``
    tuples; ``seq`` is the push order, which makes the pop order total and
    deterministic even for equal-time events.  Pushing before ``now``
    raises: time never flows backward."""

    def __init__(self):
        self._q: list = []
        self._pushes = 0
        self.now = 0.0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, at: float, kind: str, payload: Any = None) -> None:
        at = float(at)
        if at < self.now:
            raise ValueError(f"cannot schedule {kind!r} at t={at} before "
                             f"now={self.now}")
        heapq.heappush(self._q, (at, self._pushes, kind, payload))
        self._pushes += 1

    def pop(self):
        """Advance to and return the earliest event: ``(t, kind, payload)``."""
        t, _, kind, payload = heapq.heappop(self._q)
        self.now = t
        return t, kind, payload


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Seeded client latency: ``base + jitter * U1``, multiplied by
    ``straggler_factor`` when the straggler coin (``U2 < straggler_frac``)
    lands.  Both uniforms are ``ParticipationSchedule.arrival_uniforms``
    draws keyed by ``(schedule.seed, dispatch_seq, attempt)`` and indexed
    by client id; a retry (``attempt > 0``) gets a fresh draw."""

    base: float = 1.0
    jitter: float = 0.0
    straggler_frac: float = 0.0
    straggler_factor: float = 10.0

    def validate(self) -> None:
        if self.base < 0 or self.jitter < 0:
            raise ValueError(f"latency base/jitter must be >= 0, got "
                             f"base={self.base} jitter={self.jitter}")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError(f"straggler_frac must be in [0, 1], got "
                             f"{self.straggler_frac}")
        if self.straggler_factor < 1.0:
            raise ValueError(f"straggler_factor must be >= 1, got "
                             f"{self.straggler_factor}")

    def draw(self, schedule: ParticipationSchedule, dispatch_seq: int,
             client: int, n_total: int, attempt: int = 0) -> float:
        """Latency of one dispatch, a pure function of every argument."""
        u1 = schedule.arrival_uniforms(dispatch_seq, n_total, salt=2 * attempt)[client]
        lat = self.base + self.jitter * float(u1)
        if self.straggler_frac > 0.0:
            u2 = schedule.arrival_uniforms(dispatch_seq, n_total,
                                           salt=2 * attempt + 1)[client]
            if float(u2) < self.straggler_frac:
                lat *= self.straggler_factor
        return float(lat)


class EventJournal:
    """Append-only event log with a canonical byte serialization: records
    are dicts stamped with their index; ``canonical_bytes`` writes sorted
    keys, no whitespace and Python's shortest round-trip float repr, one
    record a line."""

    def __init__(self):
        self.records: list[dict] = []

    def __len__(self) -> int:
        return len(self.records)

    def append(self, ev: str, t: float, **fields) -> None:
        rec = {"i": len(self.records), "ev": str(ev), "t": float(t)}
        for k, v in fields.items():
            if isinstance(v, np.integer):
                v = int(v)
            elif isinstance(v, np.floating):
                v = float(v)
            rec[k] = v
        self.records.append(rec)

    def select(self, ev: str) -> list[dict]:
        return [r for r in self.records if r["ev"] == ev]

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for r in self.records:
            out[r["ev"]] = out.get(r["ev"], 0) + 1
        return out

    def canonical_bytes(self) -> bytes:
        lines = [json.dumps(r, sort_keys=True, separators=(",", ":"))
                 for r in self.records]
        return ("\n".join(lines) + "\n").encode("utf-8") if lines else b""

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.canonical_bytes())


def _paths(tree, path=()):
    """``(path string, leaf)`` pairs, each path spelled as the reference's
    ``str`` of a ``jax.tree_util`` key path, e.g. ``"(DictKey(key='gen'),
    DictKey(key='theta'))"``."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (f"DictKey(key={k!r})",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (f"SequenceKey(idx={i})",))
    elif tree is not None:
        yield "(" + ", ".join(path) + ("," if len(path) == 1 else "") + ")", tree


def params_digest(tree) -> str:
    """crc32 over every leaf's path string and bytes in sorted-path order,
    the reference's fingerprint: equal trees (tensors on any device, numpy
    arrays or scalars) give the reference's digest."""
    crc = 0
    for path, leaf in sorted(_paths(tree), key=lambda kv: kv[0]):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().contiguous().numpy()
        arr = np.ascontiguousarray(leaf)
        crc = zlib.crc32(path.encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return f"{crc:08x}"


# ---------------------------------------------------------------------------
# self-contained demo fleet + CLI (the determinism check's workload)
# ---------------------------------------------------------------------------


def demo_task(seed: int):
    """The demo's quadratic GAN: G is a point ``theta``, D a linear
    critic ``w``; init ``0.1`` standard normals of numpy's ``RandomState
    (seed)`` (the same values whatever generator ``init`` is given)."""
    from repro_torch.core import GANTask
    rs = np.random.RandomState(seed)
    theta0 = (0.1 * rs.standard_normal(3)).astype(np.float32)
    w0 = (0.1 * rs.standard_normal(3)).astype(np.float32)

    def init(gen):
        return {"gen": {"theta": torch.from_numpy(theta0.copy())},
                "disc": {"w": torch.from_numpy(w0.copy())}}

    def disc_loss(params, batch):
        xm = torch.mean(batch["x"], dim=0)
        g = params["gen"]["theta"].detach()
        w = params["disc"]["w"]
        return -torch.dot(w, xm - g) + 0.5 * torch.sum(w ** 2)

    def gen_loss(params, batch):
        return torch.dot(params["disc"]["w"].detach(), params["gen"]["theta"])

    return GANTask(init=init, disc_loss=disc_loss, gen_loss=gen_loss)


def demo_data(seed: int, n_clients: int, size: int = 32) -> list:
    """Non-iid host shards: client i's ``x`` is ``size`` standard normals
    (numpy, seeded by ``(seed, i)``) plus ``i``."""
    return [{"x": torch.from_numpy(
        (np.random.RandomState([seed, i]).standard_normal((size, 3)) + i).astype(np.float32))}
        for i in range(n_clients)]


def demo_driver(*, seed: int = 7, n_clients: int = 8, cohort: int = 4,
                n_rounds: int = 6, buffer_goal: int = 2,
                timeout: float | None = 6.0, device="cuda"):
    """A small quadratic-GAN async run with planted stragglers, the
    workload of ``python -m repro_torch.run.simclock``.  Everything is
    seeded from ``seed``: init and data from numpy, the schedule and the
    latencies from the reference's Threefry bits."""
    from repro_torch.core import FedGAN, FedGANConfig
    from repro_torch.data.federated import FleetRounds
    from repro_torch.optim import SGD, constant, equal_timescale
    from repro_torch.run.async_agg import AsyncAggDriver
    from repro_torch.run.virtual import StragglerPolicy
    grid = (1, cohort)
    fed = FedGAN(demo_task(seed), FedGANConfig(agent_grid=grid, sync_interval=3),
                 opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(0.05)))
    fleet = FleetRounds(demo_data(seed, n_clients), grid, batch_size=8, sync_interval=3)
    return AsyncAggDriver(
        fed, fleet, n_rounds,
        schedule=ParticipationSchedule(seed=seed),
        straggler=StragglerPolicy(mode="defer", decay=0.5, max_staleness=2),
        buffer_goal=buffer_goal,
        latency=LatencyModel(base=1.0, jitter=0.5, straggler_frac=0.25,
                             straggler_factor=8.0),
        timeout=timeout, max_retries=2, backoff=2.0, device=device)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.run.simclock",
        description="deterministic async-aggregation simulation; run twice "
                    "with the same seed and compare the journals byte for byte")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--buffer-goal", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=6.0)
    ap.add_argument("--out", default="", help="journal path (.jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) needs a GPU")
    args = ap.parse_args(argv)

    driver = demo_driver(seed=args.seed, n_clients=args.clients,
                         cohort=args.cohort, n_rounds=args.rounds,
                         buffer_goal=args.buffer_goal, timeout=args.timeout,
                         device=args.device)
    result = driver.run(args.seed)
    if args.out:
        driver.journal.write(args.out)
    digest = params_digest(result.state["params"])
    counts = driver.journal.counts()
    print(f"events={len(driver.journal)} flushes={counts.get('flush', 0)} "
          f"timeouts={counts.get('timeout', 0)} "
          f"makespan={result.timings['makespan']} params_digest={digest}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
