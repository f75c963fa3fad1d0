"""ServeEngine: continuous-batching generation over a ``Backbone`` (a port
of ``repro.serve.engine``).

One engine owns

  * a fixed decode cache of ``max_batch`` slots x ``max_seq`` positions
    (ring-width for windowed layers under ``ring=True``), written in place,
  * one decode tick at (max_batch, 1): on the card a captured CUDA graph
    (the twin of the reference's one compiled decode executable, with its
    donated cache), replayed every tick; eagerly with ``capture=False`` or
    on the CPU; and an eager prefill per request, padded to one of a
    bounded ladder of prompt-length buckets,
  * a :class:`~repro_torch.serve.batcher.Batcher` admitting queued requests
    into free slots each tick and evicting finished ones,
  * optionally a :class:`~repro_torch.serve.reload.CheckpointWatcher` that
    swaps in newer generator params between ticks (same shapes).

With ``mesh`` (a ``DeviceMesh``, e.g. ``launch.mesh.make_serving_mesh()``)
the engine serves sharded: params are placed by ``param_specs``, the
cache by ``cache_specs``, and every prefill, decode and slot write runs
under ``use_mesh`` on DTensors (on the card the tick is still one captured
graph).  Every rank of the mesh runs the same engine loop.

Every slot decodes at its *own* sequence position (``Backbone.decode``
takes a (B,) index vector), which is what lets a new request start while
its neighbours are mid-generation.  Sampling runs on the host on the
fetched logits (numpy Gumbel-max from ``rng_seed``, as the reference
does), so with the same logits both engines sample the same tokens.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch import resolve_device
from repro_torch.dist.sharding import is_sharded, named_shardings, param_specs, place, use_mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Backbone
from repro_torch.serve.batcher import Batcher, Request
from repro_torch.serve.cache import insert_slot, make_buckets, plan_layout, prefill_bucket
from repro_torch.serve.reload import CheckpointWatcher
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass
class EngineStats:
    """Operational counters a bench or operator dashboard reads.

    Per-tick samples live in bounded deques (recent-window percentiles);
    throughput/occupancy come from running aggregates, so a server ticking
    indefinitely holds O(1) memory.  A tick's and a prefill's seconds run
    until their results are on the host (the device work, not its launch)."""

    WINDOW = 4096

    ticks: int = 0
    prefills: int = 0
    reloads: int = 0
    decode_tokens: int = 0
    decode_ticks: int = 0
    total_tick_seconds: float = 0.0
    total_active: int = 0
    prefill_buckets: set = dataclasses.field(default_factory=set)
    tick_seconds: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=EngineStats.WINDOW))
    tick_active: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=EngineStats.WINDOW))
    prefill_seconds: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=EngineStats.WINDOW))

    def record_decode(self, seconds: float, active: int) -> None:
        self.decode_tokens += active
        self.decode_ticks += 1
        self.total_tick_seconds += seconds
        self.total_active += active
        self.tick_seconds.append(seconds)
        self.tick_active.append(active)

    def tick_ms(self, q: float) -> float:
        """q-th percentile decode-tick latency in ms (q in [0, 100]), over
        the last WINDOW ticks."""
        if not self.tick_seconds:
            return 0.0
        xs = sorted(self.tick_seconds)
        i = min(int(round(q / 100 * (len(xs) - 1))), len(xs) - 1)
        return xs[i] * 1e3

    def tokens_per_sec(self) -> float:
        if self.total_tick_seconds <= 0:
            return 0.0
        return self.decode_tokens / self.total_tick_seconds

    def mean_occupancy(self, max_batch: int) -> float:
        if not self.decode_ticks:
            return 0.0
        return self.total_active / (self.decode_ticks * max_batch)


class ServeEngine:
    """Continuous-batching serving of one generator architecture.

    ``params=None`` initialises from a ``torch.Generator`` on the device
    seeded with ``rng_seed`` (the reference draws from
    ``jax.random.key(rng_seed)``: the two engines' random params differ by
    construction; give both the same params to compare them).  A hot
    reload writes the new weights into the served tensors (the captured
    tick reads their addresses); with ``ckpt_dir`` set, params given here
    are copied first, so a reload never writes into the caller's tensors.
    ``mesh`` serves sharded (module docstring); it must be a ``DeviceMesh``
    of ``device``'s type."""

    def __init__(self, cfg: ArchConfig, *, max_batch: int = 4,
                 max_seq: int = 256, ring: bool = False,
                 params=None, rng_seed: int = 0, min_bucket: int = 16,
                 ckpt_dir: str = "", ckpt_extract=None, reload_every: int = 1,
                 mesh=None, device="cuda", capture: bool = True):
        self.cfg = cfg
        self.mesh = self._check_mesh(mesh, torch.device(device))
        self.device = resolve_device(device)
        self.bb = Backbone(cfg, ring_cache=ring)
        self.layout = plan_layout(cfg, max_seq, ring=ring)
        self.max_batch, self.max_seq = max_batch, max_seq
        self.buckets = make_buckets(min(min_bucket, max_seq), max_seq)
        self.batcher = Batcher(max_batch)
        self.stats = EngineStats()
        self.reload_every = max(reload_every, 1)
        self.loaded_step: Optional[int] = None
        self.captured = capture and self.device.type == "cuda"
        self._rng = np.random.default_rng(rng_seed)
        self._tokens = np.zeros((max_batch,), np.int32)
        self._indices = np.zeros((max_batch,), np.int32)

        self.watcher = None
        if ckpt_dir:
            self.watcher = CheckpointWatcher(ckpt_dir, extract=ckpt_extract,
                                             device=self.device)
        # a reload writes into the served tensors: never into the caller's
        copy = params is not None and self.watcher is not None
        if params is None and self.watcher is not None:
            got = self.watcher.poll()
            if got is not None:
                params, self.loaded_step = got
        if params is None:
            params = self.bb.init(torch.Generator(device=self.device).manual_seed(rng_seed))
        self.params = self._place_params(
            tree_map(lambda x: x.to(self.device, copy=copy), params))
        self.cache = self._place_cache(self.bb.init_cache(max_batch, max_seq,
                                                          device=self.device))
        self._param_spec = self._spec(self.params)
        # the decode tick's static inputs and, once captured, its graph and
        # static logits
        self._tok = torch.zeros((max_batch, 1), dtype=torch.int64, device=self.device)
        self._idx = torch.zeros((max_batch,), dtype=torch.int64, device=self.device)
        self._graph = None
        self._logits = None

    # ---- sharded-serving plumbing -----------------------------------------
    @staticmethod
    def _check_mesh(mesh, device):
        if mesh is None:
            return None
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh "
                            f"(launch.mesh.make_serving_mesh), got {type(mesh).__name__}")
        if mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve on {device}: "
                             f"make the mesh with device={device.type!r}")
        return mesh

    def _place_params(self, params):
        if self.mesh is None:
            return params
        return place(params, named_shardings(self.mesh, param_specs(params, self.mesh)))

    def _place_cache(self, cache):
        if self.mesh is None:
            return cache
        from repro_torch.launch.steps import cache_specs
        specs = cache_specs(cache, self.mesh, batch=self.max_batch)
        return place(cache, named_shardings(self.mesh, specs))

    @staticmethod
    def _fetch(x):
        """A result on every rank as a plain tensor (a collective on a mesh)."""
        return x.full_tensor() if is_sharded(x) else x

    @staticmethod
    def _spec(params):
        leaves, treedef = tree_flatten(params)
        return treedef, [tuple(x.shape) for x in leaves]

    # ---- request intake ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               frames=None, stop_tokens=()) -> int:
        """Queue a request; returns its id.  An audio-family request carries
        its encoder ``frames`` (S_enc, d_model)."""
        prompt = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's max_seq {self.max_seq}")
        if self.cfg.family == "audio" and frames is None:
            raise ValueError("audio family requests need encoder frames")
        req = Request(rid=-1, prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, frames=frames,
                      stop_tokens=frozenset(stop_tokens))
        return self.batcher.submit(req)

    # ---- hot reload --------------------------------------------------------
    def maybe_reload(self) -> bool:
        if self.watcher is None or self.stats.ticks % self.reload_every:
            return False
        got = self.watcher.poll()
        if got is None:
            return False
        params, step = got
        if self._spec(params) != self._param_spec:
            raise RuntimeError(
                f"checkpoint step {step} params tree does not match the "
                f"serving arch {self.cfg.name} — wrong --ckpt-dir or config?")
        for dst, src in zip(tree_leaves(self.params), tree_leaves(params)):
            if is_sharded(dst):
                # this rank's shard of the new weights into its shard
                src = distribute_tensor(src.to(self.device), dst.device_mesh,
                                        dst.placements, src_data_rank=None)
                dst, src = dst.to_local(), src.to_local()
            dst.copy_(src)
        self.loaded_step = step
        self.stats.reloads += 1
        return True

    # ---- one tick ----------------------------------------------------------
    def tick(self) -> list[Request]:
        """Evict finished requests, admit queued ones (prefill), run one
        decode step for all active slots.  Returns the evicted requests."""
        self.maybe_reload()
        finished = self.batcher.evict()
        self.stats.ticks += 1
        with use_mesh(self.mesh):
            for slot, req in self.batcher.admit():
                self._prefill_into(slot, req)
            active = self.batcher.active()
            if active:
                self._decode_tick(active)
        return finished

    def run(self, *, max_ticks: int = 1_000_000) -> dict[int, Request]:
        """Tick until every submitted request is finished; returns
        {rid: request} for all evicted requests."""
        done: dict[int, Request] = {}
        ticks = 0
        while self.batcher.has_work:
            if ticks >= max_ticks:
                raise RuntimeError(f"not drained after {max_ticks} ticks")
            ticks += 1
            for req in self.tick():
                done[req.rid] = req
        return done

    # ---- internals ---------------------------------------------------------
    def _prefill(self, toks, last: int, frames=None):
        """Bucketed prefill: forward the padded prompt (and, audio, encode
        the request's frames), take the hidden state at the last REAL token
        (``last``), project only that row to logits."""
        out = self.bb.prefill(self.params, toks, encoder_frames=frames, logits_mode="none")
        h = out["hidden"][:, last:last + 1]
        return self._fetch(self.bb.project_logits(self.params, h)), out["cache"]

    def _prefill_into(self, slot: int, req: Request) -> None:
        """Bucketed (attention families) or exact-prefix (recurrent-state
        families) prefill, written into the request's batch slot.  Any prompt
        tokens beyond the prefix land in ``req.pending`` and are fed through
        the shared decode step — chunked prefill, which threads SSM state
        exactly instead of corrupting it with pad tokens."""
        t0 = time.perf_counter()
        T = req.prompt_len
        Tb = prefill_bucket(self.cfg, T, self.buckets)
        req.pending = list(req.prompt[Tb:])  # empty for bucketed families
        if Tb == 0:
            # prompt shorter than one SSD chunk: reset the slot to fresh
            # state and feed the whole prompt through decode
            fresh = self.bb.init_cache(1, self.max_seq, device=self.device)
            insert_slot(self.cache, fresh, slot, prompt_len=0)
            req.position = 0
            self._tokens[slot] = req.pending.pop(0)
            self._indices[slot] = 0
        else:
            n = min(T, Tb)
            toks = torch.zeros((1, Tb), dtype=torch.int64)
            toks[0, :n] = torch.tensor(req.prompt[:n])
            frames = None
            if req.frames is not None:
                frames = torch.as_tensor(req.frames, device=self.device)[None]
            logits, req_cache = self._prefill(toks.to(self.device), n - 1, frames)
            insert_slot(self.cache, req_cache, slot, prompt_len=n)
            req.position = n
            self._indices[slot] = n
            if req.pending:
                self._tokens[slot] = req.pending.pop(0)
            else:
                tok = self._sample(logits[0, 0].cpu().numpy(), req)
                req.generated.append(tok)
                self._tokens[slot] = tok
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.prefills += 1
        self.stats.prefill_buckets.add(Tb)
        self.stats.prefill_seconds.append(time.perf_counter() - t0)

    def _decode(self):
        logits, self.cache = self.bb.decode(self.params, self._tok, self.cache, self._idx,
                                            donate=True)
        return logits

    def _decode_captured(self):
        """The tick through the captured graph.  The first call runs the
        tick eagerly on a side stream (kernels load, cuBLAS picks its
        algorithms) and then captures it; every later call replays."""
        if self._graph is not None:
            self._graph.replay()
            return self._logits
        compute = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            logits = self._decode()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self._logits = self._decode()
        compute.wait_stream(side)
        self._graph = graph
        return logits

    def _decode_tick(self, active) -> None:
        t0 = time.perf_counter()
        self._tok[:, 0].copy_(torch.from_numpy(self._tokens))
        self._idx.copy_(torch.from_numpy(self._indices))
        logits = self._decode_captured() if self.captured else self._decode()
        logits = self._fetch(logits)[:, 0, :self.cfg.vocab_size].cpu().numpy()
        for slot, req in active:
            req.position += 1
            self._indices[slot] += 1
            if req.pending:
                # still consuming the prompt (chunked prefill): feed the
                # next known token, ignore the logits
                self._tokens[slot] = req.pending.pop(0)
                continue
            tok = self._sample(logits[slot], req)
            req.generated.append(tok)
            if tok in req.stop_tokens:
                req.stopped = True
            self._tokens[slot] = tok
        self.stats.record_decode(time.perf_counter() - t0, len(active))

    def _sample(self, row, req: Request) -> int:
        """Host-side sampling on the already-fetched logits row (numpy)."""
        row = np.asarray(row)[: self.cfg.vocab_size]  # mask vocab padding
        if req.temperature <= 0:
            return int(row.argmax())
        g = self._rng.gumbel(size=row.shape)  # Gumbel-max == categorical
        return int((row / req.temperature + g).argmax())
