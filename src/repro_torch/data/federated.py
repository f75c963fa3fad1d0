"""Non-iid federated partitioners and the round data pipelines (a port of
``repro.data.federated``).

The paper's splits deal classes to agents (MNIST/CIFAR: B = 5 agents x 2
classes each); ``label_shard_partition`` is that scheme and
``dirichlet_partition`` the federated-learning benchmark knob.  Both draw
from numpy's ``RandomState`` as the reference does, so their index arrays
are the reference's.

Two round pipelines (the :class:`FederatedData` protocol):

* :class:`DeviceFederatedData`: every agent's shard lives on the device,
  stacked under the (P, A) agent grid; each local step gathers its
  (P, A, batch, ...) minibatch there from a ``torch.Generator`` on the
  device.  No per-round host assembly, no host-to-device copy.
* :class:`StreamingFederatedData`: for datasets too large for device
  memory.  The host assembles each round's (K, P, A, batch, ...) tensors
  (:class:`FederatedRounds`) into pinned memory and uploads them on a side
  CUDA stream, up to ``prefetch`` rounds ahead, so round r + 1 uploads
  while round r computes.  The minibatch indices and the seeds are the
  reference's bits (``repro_torch.prng``), so a round's real-data leaves
  are the reference's for the same agent data.  The ``sample_extra``
  draws (latent z, labels) are the one place the stream differs: the
  reference draws them with ``jax.random.normal``, whose bits the port
  does not reproduce, so they come from a host ``torch.Generator`` seeded
  from the words of the same key.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.tree import tree_leaves, tree_map


def _host_labels(labels) -> np.ndarray:
    if isinstance(labels, torch.Tensor):
        return labels.detach().cpu().numpy()
    return np.asarray(labels)


def label_shard_partition(labels, num_agents: int, *, classes_per_agent=None,
                          seed: int = 0) -> list:
    """Paper-style split: permute the classes, deal them to the agents in
    contiguous buckets (``np.array_split``, so the buckets differ by at
    most one class), shuffle each agent's indices.  Returns one int64
    index tensor per agent.  ``classes_per_agent`` is accepted and unused,
    as in the reference."""
    labels = _host_labels(labels)
    rng = np.random.RandomState(seed)
    order = rng.permutation(np.unique(labels))
    out = []
    for bucket in np.array_split(order, num_agents):
        idx = np.nonzero(np.isin(labels, bucket))[0]
        rng.shuffle(idx)
        out.append(torch.from_numpy(idx.astype(np.int64)))
    return out


def dirichlet_partition(labels, num_agents: int, *, alpha: float = 0.3,
                        seed: int = 0) -> list:
    """Dirichlet(alpha) class-mixture split (Hsu et al.): each class's
    shuffled indices are cut among the agents by a Dirichlet draw.
    Returns one sorted int64 index tensor per agent."""
    labels = _host_labels(labels)
    rng = np.random.RandomState(seed)
    agent_idx = [[] for _ in range(num_agents)]
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_agents)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for a, part in enumerate(np.split(idx, cuts)):
            agent_idx[a].extend(part.tolist())
    return [torch.tensor(sorted(a), dtype=torch.int64) for a in agent_idx]


def partition_sizes(parts) -> torch.Tensor:
    """The agents' shard sizes |R_i|, float32 (the §3.1 weight
    numerators)."""
    return torch.tensor([p.shape[0] for p in parts], dtype=torch.float32)


# ---------------------------------------------------------------------------
# the FederatedData protocol
# ---------------------------------------------------------------------------


class FederatedData:
    """What the round driver needs from a data pipeline, one of two
    capabilities:

    * device-resident: ``sample_step(generator) -> (P, A, batch, ...)``,
      drawn on the device inside the round (``FedGAN.round_from_data``);
    * host-streaming: ``iter_rounds(rng, n_rounds)`` yielding the
      ``(batches, seeds)`` round inputs ``FedGAN.round`` consumes.

    ``kind`` is ``"device"`` or ``"stream"`` accordingly."""

    kind: str = ""

    def sample_step(self, gen):
        raise NotImplementedError(f"{type(self).__name__} is not device-resident")

    def iter_rounds(self, rng, n_rounds: int) -> Iterator:
        raise NotImplementedError(f"{type(self).__name__} does not stream rounds")


def round_key_schedule(seed: int, n_rounds: int, device="cuda") -> list:
    """The device path's per-round generators: one seeded
    ``torch.Generator`` on ``device`` per round.  The seeds come from
    numpy's ``SeedSequence(seed)``, a different algorithm from the
    generators they seed, so an init drawn from ``torch.Generator`` seeded
    with the same ``seed`` shares no bits with any round."""
    dev = resolve_device(device)
    seeds = np.random.SeedSequence(seed).generate_state(n_rounds, dtype=np.uint64)
    return [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]


def stream_key_schedule(rng, n_rounds: int) -> list:
    """The stream path's per-round keys, the reference's
    ``round_key_schedule``: ``rng, rb = split(rng)`` per round
    (``repro_torch.prng`` key data)."""
    keys = []
    for _ in range(n_rounds):
        rng, rb = prng.split(rng)
        keys.append(rb)
    return keys


# ---------------------------------------------------------------------------
# device-resident
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceFederatedData(FederatedData):
    """Agent shards stacked on the device under the (P, A) grid.

    ``data`` leaves are (P, A, N, ...) with every agent's shard padded (by
    wrapping) to the fleet max N; ``sizes`` (P, A) holds the true per-agent
    sample counts so sampling never sees padding.  ``sample_step(gen)``
    draws one (P, A, batch, ...) minibatch uniformly per agent and merges
    ``sample_extra(gen, (P, A, batch))`` (e.g. latent z draws).  It is
    ``gather_step(draw_step(gen))``: the draws alone come first, so a
    captured round (``repro_torch.run.graph``) can take them outside the
    graph, in the same order, and gather inside it."""

    data: Any                      # dict of tensors, leaves (P, A, N, ...)
    sizes: torch.Tensor            # (P, A) int64 true shard sizes
    batch_size: int
    sample_extra: Callable | None = None

    kind = "device"

    @property
    def agent_grid(self) -> tuple:
        return tuple(self.sizes.shape[:2])

    @property
    def device(self) -> torch.device:
        return self.sizes.device

    @classmethod
    def from_agent_data(cls, agent_data: Sequence[Any], agent_grid,
                        batch_size: int, *, sample_extra: Callable | None = None,
                        device="cuda", mesh=None) -> "DeviceFederatedData":
        """Stack per-agent datasets (len B = P*A, arbitrary sizes) into the
        device-resident layout on ``device``.  With ``mesh``, leaves are
        placed with the (P, A) lead sharded over ("pod", "data"): each
        agent's shard lands on its own rank (:meth:`place`)."""
        dev = resolve_device(device)
        P, A = agent_grid
        if P * A != len(agent_data):
            raise ValueError(f"agent_grid {agent_grid} != {len(agent_data)} datasets")
        sizes = [tree_leaves(d)[0].shape[0] for d in agent_data]
        n_max = max(sizes)

        def pad(x):
            n = x.shape[0]
            return x if n == n_max else x[torch.arange(n_max, device=x.device) % n]

        def stack(*xs):
            s = torch.stack([pad(x.to(dev)) for x in xs])
            return s.reshape((P, A) + tuple(s.shape[1:]))

        data = tree_map(stack, agent_data[0], *agent_data[1:])
        out = cls(data=data,
                  sizes=torch.tensor(sizes, dtype=torch.int64).reshape(P, A).to(dev),
                  batch_size=batch_size, sample_extra=sample_extra)
        return out.place(mesh) if mesh is not None else out

    def place(self, mesh) -> "DeviceFederatedData":
        """Explicit placement: the (P, A) lead of every leaf (and of
        ``sizes``) sharded over the mesh's ("pod", "data") axes as
        ``repro_torch.dist.sharding.filter_spec`` adapts them."""
        from repro_torch.dist.sharding import NamedSharding, filter_spec, place

        def put(x):
            spec = filter_spec(mesh, ("pod", "data") + (None,) * (x.dim() - 2), x.shape)
            return place(x, NamedSharding(mesh, spec))

        return dataclasses.replace(self, data=tree_map(put, self.data), sizes=put(self.sizes))

    def draw_step(self, gen: torch.Generator) -> dict:
        """One local step's random draws from ``gen``, in the order
        ``sample_step`` makes them: the (P, A, batch) uniforms of the
        minibatch indices, then the ``sample_extra`` draws."""
        P, A = self.agent_grid
        shape = (P, A, self.batch_size)
        u = torch.rand(shape, generator=gen, device=self.device)
        extra = self.sample_extra(gen, shape) if self.sample_extra is not None else {}
        return {"u": u, "extra": extra}

    def gather_step(self, draws: dict) -> dict:
        """The (P, A, batch, ...) minibatch ``draws`` select: each agent's
        uniforms scaled to its true shard size, its samples gathered on
        the device, the extra draws merged in."""
        P, A = self.agent_grid
        B, b = P * A, self.batch_size
        n = self.sizes[..., None]
        idx = torch.minimum((draws["u"] * n).long(), n - 1).reshape(B, b)
        rows = torch.arange(B, device=self.device)[:, None]

        def gather(x):
            flat = x.reshape((B,) + tuple(x.shape[2:]))
            g = flat[rows, idx]
            return g.reshape((P, A) + tuple(g.shape[1:]))

        batch = tree_map(gather, self.data)
        return {**batch, **draws["extra"]} if draws["extra"] else batch

    def sample_step(self, gen: torch.Generator):
        return self.gather_step(self.draw_step(gen))


# ---------------------------------------------------------------------------
# host-streaming
# ---------------------------------------------------------------------------


def _host_generator(k) -> torch.Generator:
    """A host ``torch.Generator`` seeded from the two words of key ``k``."""
    return torch.Generator().manual_seed(prng.key_seed(k))


def _assemble_round(agent_data, salts, slot_grid, batch_size, sync_interval,
                    sample_extra, rng, out=None):
    """The host-side round assembler, the reference's: ``r_idx, r_extra,
    r_seed = split(rng, 3)``; agent i's K minibatch indices are
    ``randint(fold_in(r_idx, salt_i), (K, batch), 0, n_i)`` and its extra
    draws come from ``fold_in(r_extra, salt_i)``; the (K, P, A) seeds are
    ``randint(r_seed, (K, P, A), 0, 2^31 - 1)`` as uint32.  Returns
    ``(batches, seeds)``, host tensors with leading (K, P, A).  With
    ``out`` (a ``(batches, seeds)`` pair of host tensors of those shapes,
    e.g. pinned) the round is written there."""
    P, A = slot_grid
    K = sync_interval
    r_idx, r_extra, r_seed = prng.split(rng, 3)
    per_agent = []
    for data, salt in zip(agent_data, salts):
        n = tree_leaves(data)[0].shape[0]
        idx = torch.from_numpy(
            prng.randint(prng.fold_in(r_idx, salt), (K, batch_size), 0, n).astype(np.int64))
        mb = tree_map(lambda x: x[idx], data)                # (K, batch, ...)
        if sample_extra is not None:
            extra = sample_extra(_host_generator(prng.fold_in(r_extra, salt)),
                                 (K, batch_size))
            mb = {**mb, **extra}
        per_agent.append(mb)
    seeds = torch.from_numpy(
        prng.randint(r_seed, (K, P, A), 0, 2 ** 31 - 1).astype(np.uint32))
    if out is None:
        stacked = tree_map(lambda *xs: torch.stack(xs, dim=1), *per_agent)
        return tree_map(lambda x: x.reshape((K, P, A) + tuple(x.shape[2:])), stacked), seeds

    def put(dst, *xs):
        torch.stack(xs, dim=1, out=dst.view((K, P * A) + tuple(dst.shape[3:])))
        return dst

    batches = tree_map(put, out[0], *per_agent)
    out[1].copy_(seeds)
    return batches, out[1]


@dataclasses.dataclass
class FederatedRounds:
    """Assembles FedGAN round inputs on the host from per-agent datasets.

    ``agent_data``: list (len B = P*A) of dicts of host tensors (each
    agent's full local data).  ``sample_extra(generator, (K, batch))``
    returns a dict merged into each agent's minibatches (e.g. latent z
    draws), drawn from a host generator."""

    agent_data: Sequence[Any]
    agent_grid: tuple
    batch_size: int
    sync_interval: int
    sample_extra: Callable | None = None

    def __post_init__(self):
        P, A = self.agent_grid
        if P * A != len(self.agent_data):
            raise ValueError(f"agent_grid {self.agent_grid} != {len(self.agent_data)} datasets")
        for d in self.agent_data:
            for x in tree_leaves(d):
                if x.device.type != "cpu":
                    raise ValueError("FederatedRounds assembles on the host: agent data "
                                     f"must be CPU tensors, got one on {x.device}")

    def round_batches(self, rng, out=None):
        """``(batches, seeds)``: host tensors with leading (K, P, A); see
        ``_assemble_round``."""
        return _assemble_round(self.agent_data, range(len(self.agent_data)),
                               self.agent_grid, self.batch_size,
                               self.sync_interval, self.sample_extra, rng, out)


@dataclasses.dataclass
class FleetRounds:
    """Round assembler for a fleet larger than the device: ``agent_data``
    holds every registered client's local dataset (len ``A_total``, host
    tensors), but each round only the sampled cohort, ``P * A_active``
    clients, is assembled into the (K, P, A_active, batch, ...) slot
    tensors.  Draws are salted with the *global* client id, not the slot
    position, so a client sees the same data stream whichever slot it is
    paged into, and with the identity cohort the rounds are
    :class:`FederatedRounds`' over the same ``agent_data`` bit for bit."""

    agent_data: Sequence[Any]          # len A_total
    slot_grid: tuple                   # (P, A_active)
    batch_size: int
    sync_interval: int
    sample_extra: Callable | None = None

    @property
    def num_clients(self) -> int:
        return len(self.agent_data)

    @property
    def cohort_size(self) -> int:
        return self.slot_grid[0] * self.slot_grid[1]

    def __post_init__(self):
        if self.num_clients < self.cohort_size:
            raise ValueError(
                f"fleet of {self.num_clients} clients cannot fill "
                f"{self.cohort_size} device slots {self.slot_grid}")
        for d in self.agent_data:
            for x in tree_leaves(d):
                if x.device.type != "cpu":
                    raise ValueError("FleetRounds assembles on the host: client data "
                                     f"must be CPU tensors, got one on {x.device}")

    def client_sizes(self) -> np.ndarray:
        """Per-client dataset sizes |R_i| (len A_total), the §3.1 weight
        numerators of dataset-size weighting."""
        return np.asarray([tree_leaves(d)[0].shape[0] for d in self.agent_data], np.int64)

    def round_batches(self, rng, slot_clients, out=None):
        """One round for ``slot_clients``, the global client id in each
        slot, in slot order (len ``P * A_active``); see
        ``_assemble_round``."""
        ids = [int(c) for c in slot_clients]
        if len(ids) != self.cohort_size:
            raise ValueError(f"got {len(ids)} cohort ids for "
                             f"{self.cohort_size} slots")
        return _assemble_round([self.agent_data[c] for c in ids], ids,
                               self.slot_grid, self.batch_size,
                               self.sync_interval, self.sample_extra, rng, out)


class _PinnedUpload:
    """The card half of the stream: a ring of ``slots`` pinned host
    buffers, each round assembled into one and copied to fresh device
    tensors with ``non_blocking=True`` on a side stream, an event recorded
    after the copy.  A slot is written again only after the round that
    consumed it was handed out and its copy's event has completed.
    ``rounds`` is a :class:`FederatedRounds` or a :class:`FleetRounds`;
    ``launch`` passes its arguments on to ``rounds.round_batches``."""

    def __init__(self, rounds, slots: int, device: torch.device):
        self.rounds, self.device = rounds, device
        self.stream = torch.cuda.Stream(device)
        self.pins: list = [None] * slots
        self.events: list = [None] * slots
        self.n = 0

    def launch(self, *args):
        """Assemble and start uploading one round; returns its pending
        (batches, seeds, event) on the device."""
        slot = self.n % len(self.pins)
        self.n += 1
        if self.pins[slot] is None:   # first use: pin the slot's round
            self.pins[slot] = tree_map(lambda x: x.pin_memory(),
                                       self.rounds.round_batches(*args))
        else:
            self.events[slot].synchronize()   # that slot's last copy has landed
            self.rounds.round_batches(*args, out=self.pins[slot])
        batches, seeds = self.pins[slot]
        with torch.cuda.stream(self.stream):
            up = lambda x: torch.empty(x.shape, dtype=x.dtype, device=self.device).copy_(  # noqa: E731
                x, non_blocking=True)
            dev_batches = tree_map(up, batches)
            # uint32 travels as its int32 bits
            dev_seeds = up(seeds.view(torch.int32)).view(torch.uint32)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return dev_batches, dev_seeds, event

    def take(self, pending):
        """Hand a pending round to the current (compute) stream: it waits
        on the upload's event, and every tensor is marked in use there so
        the allocator keeps it until the round has read it."""
        batches, seeds, event = pending
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for x in tree_leaves(batches) + [seeds]:
            x.record_stream(compute)
        return batches, seeds


@dataclasses.dataclass
class StreamingFederatedData(FederatedData):
    """Host-streaming rounds with prefetch.

    Wraps a :class:`FederatedRounds` assembler: ``iter_rounds`` assembles
    and uploads up to ``prefetch`` future rounds while the current round
    computes.  On the card each round goes through pinned memory and a
    side stream (``_PinnedUpload``); on the CPU the rounds are yielded as
    host tensors.  The key schedule, and so every batch, is the blocking
    loop's, whatever the depth."""

    rounds: FederatedRounds
    prefetch: int = 2
    device: Any = "cuda"

    kind = "stream"

    @property
    def agent_grid(self) -> tuple:
        return tuple(self.rounds.agent_grid)

    @property
    def batch_size(self) -> int:
        return self.rounds.batch_size

    @classmethod
    def from_agent_data(cls, agent_data, agent_grid, batch_size: int,
                        sync_interval: int, *, sample_extra=None, prefetch: int = 2,
                        device="cuda") -> "StreamingFederatedData":
        """Stream ``agent_data`` (moved to the host) to ``device``."""
        dev = resolve_device(device)
        host = [tree_map(lambda x: x.cpu(), d) for d in agent_data]
        return cls(FederatedRounds(host, agent_grid, batch_size, sync_interval,
                                   sample_extra=sample_extra),
                   prefetch=prefetch, device=dev)

    def iter_rounds(self, rng, n_rounds: int):
        """Yield ``(batches, seeds)`` for the ``n_rounds`` keys of
        ``stream_key_schedule(rng, n_rounds)``, in order."""
        if self.prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {self.prefetch}")
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            up = _PinnedUpload(self.rounds, self.prefetch + 1, dev)
            launch, take = up.launch, up.take
        else:
            launch, take = self.rounds.round_batches, lambda pending: pending
        keys = iter(stream_key_schedule(rng, n_rounds))
        buf = collections.deque()
        for rb in keys:
            buf.append(launch(rb))
            if len(buf) >= self.prefetch:
                break
        for rb in keys:
            yield take(buf.popleft())
            buf.append(launch(rb))
        while buf:
            yield take(buf.popleft())
