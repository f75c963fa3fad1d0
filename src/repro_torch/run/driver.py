"""The round driver (a port of ``repro.run.driver.RoundDriver``).

Two data paths, as in the reference:

* **device-resident** (``DeviceFederatedData``): each round draws its K
  minibatches on the device (``FedGAN.round_from_data``) from its own
  seeded generator.  With ``rounds_per_chunk`` > 1 on the card, the
  rounds run in chunks through one captured CUDA graph of the round
  (``repro_torch.run.graph``): the chunk's first round eager, every later
  round a replay with no host read in between.  Chunks never cross an
  eval or checkpoint boundary.  The two strategies whose sync reads the
  round index on the host (``reads_round_on_host``) run every round
  eagerly, and the run reports ``captured: False``.
* **host-streaming** (``StreamingFederatedData``, or a bare
  ``FederatedRounds``, which is wrapped into one): each round's
  host-assembled batches arrive through the prefetching upload, and the
  round is ``FedGAN.round``.

No round waits on the device for its metrics: each round's row lands in a
(n_rounds, n_metrics) tensor on the device, read at ``log_every``
boundaries and once, all together, at the end.

Under DP-SGD (``FedGANConfig.dp``) the driver refuses an accountant
``sample_rate`` below what the pipeline delivers
(``check_dp_sample_rate``), reports ``timings["dp_epsilon"]`` and adds
``dp_epsilon`` to every eval's scores, on either path, captured or not.
The DP noise of a streamed round comes from that round's generator of
``round_key_schedule``, as a device round's does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch import prng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data.federated import (DeviceFederatedData, FederatedRounds, FleetRounds,
                                        StreamingFederatedData, round_key_schedule)
from repro_torch.run.graph import CapturedRound, metric_row
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class RunResult:
    """``history`` is one dict of float metrics per round, ``evals`` one
    dict per eval point, ``timings`` the wall-clock accounting: total
    seconds, steps per second, the round gap (the host work between round
    dispatches per round: on the stream path the time blocked waiting for
    the next round's data; an upper bound on device idle time), the data
    path's kind and whether the rounds ran captured."""

    fed: Any
    state: Any
    history: list
    evals: list
    timings: dict

    def legacy_tuple(self):
        return self.fed, self.state, self.history


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chunk_sizes(n_rounds: int, per_chunk: int, *cadences: int) -> list:
    """Split ``n_rounds`` into chunks of at most ``per_chunk`` that never
    cross a nonzero cadence boundary (evals and checkpoints must observe
    the state at exactly their round)."""
    per_chunk = max(per_chunk, 1)
    sizes, r = [], 0
    while r < n_rounds:
        c = min(per_chunk, n_rounds - r)
        for cad in cadences:
            if cad:
                c = min(c, cad - r % cad)
        sizes.append(c)
        r += c
    return sizes


def _dp_data_shape(data):
    """(batch_size, smallest per-agent dataset size) of the pipeline, or
    None when the data object does not expose them."""
    if isinstance(data, DeviceFederatedData):
        # one host read of the shard sizes, before the round loop
        return data.batch_size, int(data.sizes.min())
    rounds = data.rounds if isinstance(data, StreamingFederatedData) else data
    if isinstance(rounds, (FederatedRounds, FleetRounds)):
        n_min = min(tree_leaves(d)[0].shape[0] for d in rounds.agent_data)
        return rounds.batch_size, n_min
    return None


def check_dp_sample_rate(dp, data):
    """Refuse an accountant ``sample_rate`` the pipeline does not deliver.

    Every step samples ``batch_size`` examples from each agent's dataset,
    so the worst-case per-example participation rate is ``min(1,
    batch_size / min_i |R_i|)``.  A configured q below that makes
    ``DPSGD.epsilon`` report a spend the mechanism does not achieve, so
    this raises."""
    shape = _dp_data_shape(data)
    if shape is None:
        return
    batch_size, n_min = shape
    q_actual = min(1.0, batch_size / max(n_min, 1))
    if dp.sample_rate < q_actual - 1e-9:
        raise ValueError(
            f"DPSGD sample_rate={dp.sample_rate} understates the pipeline's "
            f"participation rate: batch_size={batch_size} from a smallest "
            f"agent dataset of {n_min} examples samples at rate "
            f"{q_actual:.6g} per step, so the accountant's epsilon would "
            "not be delivered — set sample_rate >= batch_size / min |R_i| "
            "(or leave the conservative default of 1.0)")


class _Table:
    """The run's metrics, one (n_metrics,) row per round, on the device
    until the end of the run."""

    def __init__(self, n_rounds: int):
        self.n_rounds, self.keys, self.rows = n_rounds, None, None

    def put(self, r: int, keys, row: torch.Tensor):
        if self.rows is None:
            self.keys = list(keys)
            self.rows = torch.empty((self.n_rounds, len(self.keys)),
                                    dtype=row.dtype, device=row.device)
        self.rows[r].copy_(row)

    def round(self, r: int) -> dict:
        return dict(zip(self.keys, self.rows[r].tolist()))

    def history(self) -> list:
        if self.rows is None:
            return []
        return [dict(zip(self.keys, row)) for row in self.rows.tolist()]


@dataclasses.dataclass
class RoundDriver:
    """Drives ``n_rounds`` FedGAN rounds over a ``DeviceFederatedData``, a
    ``StreamingFederatedData`` or a bare ``FederatedRounds``.
    ``eval_hooks`` entries are callables ``(fed, state, round_idx) ->
    dict``, run every ``eval_every`` rounds on the state right after the
    round's sync.  With ``ckpt_dir`` and ``ckpt_every`` the state after
    round r is saved at step (r + 1)·K whenever ``(r + 1) % ckpt_every ==
    0``, with metadata ``{"round": r, "K": K}``.  ``rounds_per_chunk``
    (device data) runs that many rounds per chunk, captured on the card."""

    fed: Any
    data: Any
    n_rounds: int
    log_every: int = 1
    eval_every: int = 0
    eval_hooks: Sequence[Callable] = ()
    ckpt_every: int = 0
    ckpt_dir: str = ""
    rounds_per_chunk: int = 1
    verbose: bool = True

    def __post_init__(self):
        if isinstance(self.data, FederatedRounds):
            self.data = StreamingFederatedData(self.data)
        if getattr(self.data, "kind", "") not in ("device", "stream"):
            raise ValueError("data must be a DeviceFederatedData, a "
                             "StreamingFederatedData or a FederatedRounds")
        if self.eval_every and not self.eval_hooks:
            raise ValueError("eval_every is set but eval_hooks is empty")
        if self.rounds_per_chunk < 1:
            raise ValueError(f"rounds_per_chunk must be >= 1, got {self.rounds_per_chunk}")

    @property
    def device(self) -> torch.device:
        return torch.device(self.data.device)

    def run(self, seed, state=None) -> RunResult:
        """Execute the round loop.  ``seed`` (an int, or a
        ``repro_torch.prng`` key, which stands for ``prng.seed_int`` of it
        where an int is needed) seeds the rounds' draws: the device path's
        per-round generators (``round_key_schedule``), the stream path's
        keys (``stream_key_schedule(prng.as_key(seed))``, the reference's
        schedule from ``jax.random.key(seed)`` or from that key).
        ``state`` defaults to a fresh init from a ``torch.Generator``
        seeded with ``prng.seed_int(seed)``."""
        dev = self.device
        dp = self.fed.cfg.dp
        if dp is not None:
            check_dp_sample_rate(dp, self.data)
        if state is None:
            state = self.fed.init_state(torch.Generator().manual_seed(prng.seed_int(seed)),
                                        device=dev)
        self._evals, table = [], _Table(self.n_rounds)
        t0 = time.perf_counter()
        run = self._run_device if self.data.kind == "device" else self._run_stream
        # hand the state over: this frame keeps no reference to it, so the
        # initial state is freed once the first round has its output, not
        # pinned for the whole run (at a backbone's width, as large as the
        # state the rounds work on)
        handoff = [state]
        del state
        state, gap, captured = run(seed, handoff, table)
        _synchronize(dev)
        total = time.perf_counter() - t0
        K = self.fed.cfg.sync_interval
        timings = {
            "total_s": total,
            "steps_per_s": self.n_rounds * K / max(total, 1e-9),
            "round_gap_s": gap / max(self.n_rounds, 1),
            "data_kind": self.data.kind,
            "captured": captured,
        }
        if dp is not None:
            timings["dp_epsilon"] = dp.epsilon(self.n_rounds * K)
        # one fetch for the whole run, after every round was dispatched
        return RunResult(self.fed, state, table.history(), self._evals, timings)

    def _run_stream(self, seed, handoff, table):
        """One eager ``FedGAN.round`` per streamed round; the gap is the
        time blocked on the next round's data.  The port's losses take no
        random state, so the streamed seeds go unread; DP-SGD noise comes
        from the round's generator of ``round_key_schedule``."""
        state = handoff.pop()
        gap = 0.0
        it = self.data.iter_rounds(prng.as_key(seed), self.n_rounds)
        gens = (round_key_schedule(prng.seed_int(seed), self.n_rounds, self.device)
                if self.fed.cfg.dp_noise else [None] * self.n_rounds)
        for r in range(self.n_rounds):
            t = time.perf_counter()
            batches, _seeds = next(it)
            gap += time.perf_counter() - t
            state, m = self.fed.round(state, batches, gens[r])
            table.put(r, sorted(m), metric_row(m, sorted(m)))
            self._boundaries(state, r, table)
        return state, gap, False

    def _run_device(self, seed, handoff, table):
        """The rounds in chunks (``_chunk_sizes``), captured on the card
        unless a chunk is one round or the strategy reads the round on the
        host; the gap is all host work between round dispatches (generator
        set-up, boundary hooks)."""
        captured = (self.device.type == "cuda" and self.rounds_per_chunk > 1
                    and not self.fed.cfg.resolve_strategy().reads_round_on_host)
        runner = None
        state = handoff.pop()
        gap, r = 0.0, 0
        t_host = time.perf_counter()
        gens = round_key_schedule(prng.seed_int(seed), self.n_rounds, self.device)
        for c in _chunk_sizes(self.n_rounds, self.rounds_per_chunk,
                              self.eval_every, self.ckpt_every):
            for rr in range(r, r + c):
                gap += time.perf_counter() - t_host
                if not captured:
                    state, m = self.fed.round_from_data(state, self.data, gens[rr])
                    row, keys = metric_row(m, sorted(m)), sorted(m)
                elif runner is None:
                    runner = CapturedRound(self.fed, self.data, state, gens[rr])
                    row, keys = runner.metrics, runner.keys
                else:
                    row, keys = runner.replay(gens[rr]), runner.keys
                table.put(rr, keys, row)
                t_host = time.perf_counter()
            if runner is not None:
                state = runner.state
            for rr in range(r, r + c):
                self._boundaries(state, rr, table, snapshot=runner is not None)
            r += c
        gap += time.perf_counter() - t_host
        return state, gap, captured   # static buffers outlive the graph

    def _boundaries(self, state, r, table, snapshot=False):
        """Per-round host work: logging (the only mid-run metric fetch),
        the periodic eval hooks and the periodic checkpoints.  With
        ``snapshot`` the hooks get a copy of the state: the captured
        graph's static buffers change under the next replay."""
        K = self.fed.cfg.sync_interval
        last = r == self.n_rounds - 1
        if self.log_every and (r % self.log_every == 0 or last):
            m = table.round(r)
            if self.verbose:
                print(f"round {r:5d}/{self.n_rounds} step {(r + 1) * K:6d} "
                      f"d_loss={m['d_loss']:.4f} g_loss={m['g_loss']:.4f}",
                      flush=True)
        if self.eval_every and ((r + 1) % self.eval_every == 0 or last):
            seen = tree_map(torch.clone, state) if snapshot else state
            scores = {}
            for hook in self.eval_hooks:
                scores.update(hook(self.fed, seen, r))
            dp = self.fed.cfg.dp
            if dp is not None:
                # the closed-form accountant: the spend of the (r + 1)·K
                # local steps so far
                scores["dp_epsilon"] = dp.epsilon((r + 1) * K)
            self._evals.append({"round": r, "step": (r + 1) * K, **scores})
        if self.ckpt_dir and self.ckpt_every and (r + 1) % self.ckpt_every == 0:
            save_checkpoint(self.ckpt_dir, state, step=(r + 1) * K,
                            metadata={"round": r, "K": K})


def train(fed, data, n_rounds: int, seed: int, **kwargs) -> RunResult:
    """One-call convenience over :class:`RoundDriver`."""
    return RoundDriver(fed, data, n_rounds, **kwargs).run(seed)
