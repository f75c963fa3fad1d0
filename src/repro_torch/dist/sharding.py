"""Sharding substrate (a port of ``repro.dist.sharding``): who holds which
parameters, and what moves between ranks.

FedGAN state stacks every parameter leaf with a leading (P, A) agent grid
sharded over the ("pod", "data") mesh axes; tensor parallelism over
"model" lives *inside* each agent.  This module supplies the two halves
of that story, on a ``torch.distributed`` ``DeviceMesh``:

  activations  ``batch_axes`` / ``batch_spec`` / ``shard``: model code
               declares constraints positionally ("batch dims, then these
               trailing entries") and the active :func:`batch_axes` context
               decides which mesh axes the batch dims occupy.  ``shard``
               redistributes a DTensor to the filtered spec; without a
               mesh (:func:`use_mesh`) or on a plain tensor it is the
               identity, so the same model code runs unsharded.

  parameters   ``param_specs``: name-rule tensor parallelism (column- or
               row-parallel by module name, divisibility fallback to
               replicated), with ``lead=`` for the agent-stacked leading
               dims and ``fsdp_axis=`` for additionally sharding weights
               inside an agent.  ``dp_param_specs`` is the ZeRO-style
               variant of the intra-agent DP plan.

Every helper funnels through :func:`filter_spec`, which adapts a requested
spec to a concrete mesh: axis names the mesh lacks are dropped, a dim the
remaining axes do not divide falls back to replicated, and an axis already
consumed by an earlier dim is never reused.  The spec functions read only
the mesh's axis names and sizes (``mesh_dim_names`` and ``shape``), so an
:class:`AbstractMesh` stands in for a mesh of any shape without ranks.

A :class:`PartitionSpec` holds the reference's entries; :func:`to_placements`
turns one into DTensor placements (``Shard(d)`` or ``Replicate()`` per mesh
dim), :func:`named_shardings` a spec tree into a tree of
:class:`NamedSharding`, and :func:`place` puts a tree of tensors on the
mesh by such a tree (``distribute_tensor`` leaf by leaf).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map

# The production default: activation batch dims live on the agent grid.
DEFAULT_BATCH_AXES = ("pod", "data")

_local = threading.local()


class PartitionSpec:
    """One entry per leading dim: an axis name, a tuple of axis names, or
    None (replicated); missing trailing entries mean replicated.  Equal to
    a tuple (or a reference spec's entries) of the same entries."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(map(repr, self._entries)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no ranks behind it: enough for
    every spec function (the twin of ``jax.sharding.AbstractMesh``)."""

    shape: tuple
    mesh_dim_names: tuple


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, and the DTensor placements it denotes."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


# ---------------------------------------------------------------------------
# the current mesh and the batch-axes context
# ---------------------------------------------------------------------------


def current_mesh():
    """The mesh bound by the innermost :func:`use_mesh`, or None (every
    constraint is then the identity)."""
    return getattr(_local, "mesh", None)


@contextmanager
def use_mesh(mesh):
    """Bind ``mesh`` for the enclosed code (the twin of ``jax.set_mesh``).
    On a ``DeviceMesh`` plain tensors meeting DTensors count as replicated
    (``implicit_replication``): masks, positions and other constants that
    model code makes on the fly.  Nests and restores."""
    prev = current_mesh()
    _local.mesh = mesh
    try:
        if mesh is None or isinstance(mesh, AbstractMesh):
            yield mesh
        else:
            from torch.distributed.tensor.experimental import implicit_replication
            _register_missing_rules()
            with implicit_replication():
                yield mesh
    finally:
        _local.mesh = prev


_RULES_DONE = []


def _register_missing_rules():
    """Sharding rules for the ops the port runs on DTensors that some
    PyTorch versions leave without one (``register_sharding``), so such an
    op is sharded by its rule instead of failing.  Once a process."""
    if _RULES_DONE:
        return
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    prop = getattr(getattr(DTensor, "_op_dispatcher", None), "sharding_propagator", None)
    known = set()
    for table in ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"):
        known |= set(getattr(prop, table, {}))
    if aten.squeeze.dims not in known:
        @register_sharding(aten.squeeze.dims)
        def _squeeze_dims(x, dims):
            # squeeze.dims drops the listed dims of size 1; a kept dim's
            # shard moves down by the dropped dims before it
            nd = len(x.shape)
            gone = {d % nd for d in dims if x.shape[d % nd] == 1}
            out = [([Replicate()], [Replicate(), None]), ([Partial()], [Partial(), None])]
            for d in range(nd):
                if d not in gone:
                    out.append(([Shard(d - sum(g < d for g in gone))], [Shard(d), None]))
            return out
    _RULES_DONE.append(True)


def current_batch_axes() -> tuple:
    """Mesh axes currently carrying activation batch dims."""
    return getattr(_local, "batch_axes", DEFAULT_BATCH_AXES)


@contextmanager
def batch_axes(*axes: str):
    """Rebind the activation batch axes for the enclosed code.

    ``batch_axes()`` (no arguments) means *no* batch sharding (per-agent
    compute whose batch dim is already inside an agent), while
    ``batch_axes("model")`` is the intra-agent DP plan.  Nests and
    restores (the previous binding returns on exit, even on exception)."""
    prev = current_batch_axes()
    _local.batch_axes = tuple(axes)
    try:
        yield
    finally:
        _local.batch_axes = prev


def batch_spec(*trailing):
    """Positional spec entries: the batch entry, then ``trailing`` verbatim.
    The batch entry is the current :func:`batch_axes` tuple, or None when
    the context is empty."""
    axes = current_batch_axes()
    return ((tuple(axes) if axes else None),) + trailing


# ---------------------------------------------------------------------------
# spec filtering (mesh adaptation)
# ---------------------------------------------------------------------------


def mesh_dims(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def filter_spec(mesh, entries, shape) -> PartitionSpec:
    """Adapt requested spec ``entries`` to ``mesh`` and ``shape``.

    Per dim (entry may be an axis name, a tuple of axis names, or None):
      1. drop axis names the mesh does not have;
      2. drop axis names already used by an earlier dim (first dim wins);
      3. if the surviving axes do not evenly divide the dim, or their
         sizes multiply to 1, the whole dim is replicated.
    Returns a PartitionSpec with exactly ``len(entries)`` entries."""
    dims = mesh_dims(mesh)
    if len(entries) > len(shape):
        raise ValueError(f"spec {entries} has more entries than shape {tuple(shape)}")
    used: set = set()
    out = []
    for entry, size in zip(entries, shape):
        if entry is None:
            out.append(None)
            continue
        names = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        keep = [n for n in names if n in dims and n not in used]
        prod = math.prod(dims[n] for n in keep)
        if not keep or prod == 1 or size % prod != 0:
            out.append(None)
            continue
        used.update(keep)
        out.append(tuple(keep) if len(keep) > 1 else keep[0])
    return PartitionSpec(*out)


def to_placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that an entry of tensor dim d names, ``Replicate()`` on the rest.
    An entry naming several axes shards its dim over them major to minor,
    so it must list them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} must list the mesh axes in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------


def shard(x, *entries):
    """Constrain ``x`` to ``entries`` on the current mesh: redistribute the
    DTensor to the filtered spec.  Entries beyond ``x.ndim`` are rejected;
    missing trailing entries mean replicated.  The identity with no mesh
    bound, no entries, an all-replicated filtered spec (as the reference
    leaves such a tensor unconstrained) or a plain tensor: inside
    ``torch.func`` transforms (the agents' vmap) tensors are wrapped, and
    DTensor's own sharding propagation decides there."""
    mesh = current_mesh()
    if mesh is None or not entries or not is_sharded(x):
        return x
    spec = filter_spec(mesh, entries, x.shape)
    if all(e is None for e in spec):
        return x
    return x.redistribute(x.device_mesh, to_placements(mesh, spec))


def shard_attn_qkv(q, k, v):
    """Constrain attention projections (B, T, heads, head_dim).

    Batch over the active batch axes; heads over "model" when the head
    count divides, otherwise head_dim (GQA kv heads are often fewer than
    the model axis).  Under the DP plan the batch entry consumes "model"
    and the head entries are dropped by :func:`filter_spec`'s reuse
    rule."""
    mesh = current_mesh()
    if mesh is None:
        return q, k, v
    model = mesh_dims(mesh).get("model", 1)

    def one(t):
        if t.ndim < 4:
            return shard(t, *batch_spec())
        if model > 1 and t.shape[-2] % model == 0:
            ent = (None, "model", None)
        else:
            ent = (None, None, "model")
        return shard(t, *batch_spec(*ent))

    return one(q), one(k), one(v)


def whole_dims(x, *dims):
    """``x`` with the tensor dims ``dims`` unsharded: a DTensor sharded on
    one of them is redistributed to replicated on those mesh dims (a
    ``Partial`` is reduced); every other sharding is kept.  A kernel that
    contracts a dim (attention's head_dim, a scan's time axis) takes it
    whole."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    nd = x.ndim
    whole = {d % nd for d in dims}
    want = tuple(Replicate() if (isinstance(p, Shard) and p.dim % nd in whole)
                 or p.is_partial() else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def local_kernel(fn, out_placements, *args):
    """``fn`` on the local shards of DTensor ``args`` (the kernel sees plain
    tensors), its outputs wrapped as DTensors with ``out_placements`` (one
    placements tuple per output, or one for a single output), through
    ``local_map``.  Plain ``args`` call ``fn`` directly."""
    dts = [a for a in args if is_sharded(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    in_pl = tuple(a.placements if is_sharded(a) else None for a in args)
    # one placements tuple per output, always: a bare tuple of placements
    # is read as one output per placement by some versions of local_map
    single = all(isinstance(p, Placement) for p in out_placements)
    outs = local_map((lambda *a: (fn(*a),)) if single else fn,
                     out_placements=(tuple(out_placements),) if single else
                     tuple(tuple(p) for p in out_placements),
                     in_placements=in_pl, device_mesh=mesh, redistribute_inputs=False)(*args)
    return outs[0] if single else outs


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# Tensor-parallel name rules (matched against any component of the leaf's
# key path; ROW wins over COL when both appear).
#   COL: output-dim ("column") parallel, dim -1 over "model".
#   ROW: input-dim ("row") parallel, dim -2 over "model" (the matmul
#        contracts the sharded dim; its output is a partial sum).
# Everything unmatched (norm scales and biases, SSD scalars) is replicated
# within the agent.
COL_PARALLEL = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "w_gate", "w_up", "router",
    "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj", "proj_in", "head",
    "conv",
})
ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj"})


def _map_with_path(f, tree, path=()):
    """``f(path, leaf)`` over a nested dict/list/tuple tree; ``path`` is the
    tuple of dict keys and sequence indices (as strings) down to the
    leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(f, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(f, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return f(path, tree)


def _rule_entries(names, shape, *, fsdp_axis=None) -> list:
    """Trailing-dim entries for one leaf under the TP name rules."""
    nd = len(shape)
    ent: list = [None] * nd
    if nd == 0:
        return ent
    hit = set(names)
    if hit & ROW_PARALLEL:
        if nd >= 2:
            ent[-2] = "model"
            if fsdp_axis:
                ent[-1] = fsdp_axis
    elif hit & COL_PARALLEL:
        ent[-1] = "model"
        if fsdp_axis and nd >= 2:
            ent[-2] = fsdp_axis
    elif fsdp_axis:
        # unmatched leaves (norms, biases, SSD params): plain FSDP on the
        # trailing dim, gathered at use
        ent[-1] = fsdp_axis
    return ent


def param_specs(tree, mesh, *, lead: tuple = (), fsdp_axis: str | None = None):
    """Name-rule PartitionSpec tree for a parameter (or optimizer) tree.

    ``lead`` names one mesh axis per *leading* dim of every leaf (the
    agent-stacked (P, A) dims of FedGAN state).  The TP rules anchor to the
    *trailing* dims, so the same rules serve stacked and flat params.
    ``fsdp_axis`` additionally shards the matmul-complement dim of every
    weight over that axis.  Leaves are anything with ``.shape`` (meta
    tensors included)."""
    lead = tuple(lead)

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        n_lead = min(len(lead), len(shape))
        entries = list(lead[:n_lead]) + _rule_entries(path, shape[n_lead:],
                                                      fsdp_axis=fsdp_axis)
        return filter_spec(mesh, tuple(entries), shape)

    return _map_with_path(spec_of, tree)


def dp_param_specs(tree, mesh, *, lead: tuple = ()):
    """ZeRO-style specs for the intra-agent DP plan (``agents-data-dp``):
    every leaf is stored sharded over "model" along its innermost evenly
    divisible dim past ``lead`` and gathered at use."""
    lead = tuple(lead)
    model = mesh_dims(mesh).get("model", 1)

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        n_lead = min(len(lead), len(shape))
        entries = list(lead[:n_lead]) + [None] * (len(shape) - n_lead)
        if model > 1:
            for i in range(len(shape) - 1, n_lead - 1, -1):
                if shape[i] % model == 0:
                    entries[i] = "model"
                    break
        return filter_spec(mesh, tuple(entries), shape)

    return _map_with_path(spec_of, tree)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def named_shardings(mesh, tree):
    """PartitionSpec tree -> NamedSharding tree on ``mesh`` (other leaves
    pass through)."""
    return tree_map(lambda s: NamedSharding(mesh, s) if isinstance(s, PartitionSpec) else s,
                    tree)


def place(tree, shardings):
    """Put a tree of tensors on the mesh: each leaf is ``distribute_tensor``'d
    by the matching NamedSharding (the twin of ``jax.device_put``), with
    rank 0's values (a collective: every rank calls it; a replicated
    contiguous leaf is broadcast in place, not copied).  A leaf whose
    sharding is None stays as it is; a DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, s):
        if s is None or x is None:
            return x
        if is_sharded(x):
            return x.redistribute(s.mesh, s.placements)
        return distribute_tensor(x, s.mesh, s.placements)

    return _zip_place(put, tree, shardings)


def _zip_place(f, tree, shardings):
    if isinstance(tree, dict):
        return {k: _zip_place(f, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_place(f, v, s) for v, s in zip(tree, shardings))
    return f(tree, shardings)


def full_tree(tree):
    """Every DTensor leaf gathered into a plain tensor on each rank (a
    collective: every rank calls it); plain leaves pass through."""
    return tree_map(lambda x: x.full_tensor() if is_sharded(x) else x, tree)


def shape_of(x) -> tuple:
    """Shape of a tensor, a meta tensor, or anything with ``.shape``."""
    return tuple(x.shape)



# ---------------------------------------------------------------------------
# manual agent axes
# ---------------------------------------------------------------------------


class AgentShards:
    """The agent axes of a mesh made manual, the rest left to DTensor (the
    twin of ``shard_map`` over ("pod", "data") with "model" automatic).

    FedGAN's agents are independent between syncs, and every plan puts
    one agent on each index of its agent axes.  ``local`` turns a tree of
    (P, A, ...) DTensors on the whole mesh into the rank's own agents,
    (p, a, ...) DTensors on the submesh of the other axes (plain tensors
    when none is left), with those axes' placements kept; ``to_global``
    puts such a tree back, its agent dims sharded as ``like``'s.  Both
    move no data.  The agents' ``vmap`` then sees no sharded agent dim:
    DTensor cannot merge a vmapped dim of more than one into a sharded one
    (the einsum of attention fails there)."""

    def __init__(self, mesh, agent_dims: tuple):
        self.mesh, self.agent_dims = mesh, tuple(agent_dims)
        # a mesh dim of size 1 shards nothing: it is left out of the inner
        # mesh (DTensor may place a Shard there that blocks a view)
        self.inner = tuple(i for i in range(mesh.ndim)
                           if i not in self.agent_dims and mesh.shape[i] > 1)
        names = mesh.mesh_dim_names
        self.inner_mesh = mesh[tuple(names[i] for i in self.inner)] if self.inner else None

    @classmethod
    def of(cls, tree):
        """The manual view of a tree whose DTensor leaves shard an agent dim
        (dim 0 or 1), or None (plain leaves, or no agent dim sharded: the
        agents' vmap then runs on the DTensors as they are)."""
        from torch.distributed.tensor import Shard
        leaves = [x for x in tree_leaves(tree) if is_sharded(x)]
        dims = sorted({i for x in leaves for i, p in enumerate(x.placements)
                       if isinstance(p, Shard) and p.dim < 2})
        return cls(leaves[0].device_mesh, tuple(dims)) if dims else None

    def local(self, tree):
        from torch.distributed.tensor import DTensor

        def one(x):
            if not is_sharded(x):
                return x
            if self.inner_mesh is None:
                return x.to_local()
            return DTensor.from_local(x.to_local(), self.inner_mesh,
                                      [x.placements[i] for i in self.inner], run_check=False)

        return tree_map(one, tree)

    def batch_dims(self, batch) -> tuple:
        """The mesh dims (of the inner mesh) that shard a local batch: the
        data parallelism inside an agent."""
        from torch.distributed.tensor import Shard
        return tuple(sorted({i for x in tree_leaves(batch) if is_sharded(x)
                             for i, p in enumerate(x.placements) if isinstance(p, Shard)}))

    @staticmethod
    def gathered(tree, dims):
        """Every DTensor leaf with its shards on the mesh dims ``dims``
        gathered (weights stored sharded over a data-parallel axis are
        gathered at use, as FSDP does)."""
        from torch.distributed.tensor import Replicate

        def one(x):
            if not is_sharded(x) or not dims:
                return x
            want = tuple(Replicate() if i in dims else p for i, p in enumerate(x.placements))
            return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)

        return tree_map(one, tree)

    @staticmethod
    def placed_like(tree, like):
        """Each DTensor leaf redistributed to the placements of the matching
        leaf of ``like`` (gradients of gathered weights reduce-scattered
        back to the weights' shards)."""
        return tree_map(lambda x, ref: x.redistribute(ref.device_mesh, ref.placements)
                        if is_sharded(x) else x, tree, like)

    def to_global(self, tree, like):
        """``tree`` (this rank's agents, leading (p, a) dims as ``like``'s
        leaves) on the whole mesh, each leaf's agent placements those of
        the matching leaf of ``like`` (a tree of the same structure, or one
        DTensor for every leaf)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        def one(x, ref):
            inner = list(x.placements) if is_sharded(x) else [Replicate()] * len(self.inner)
            pl = [Replicate()] * self.mesh.ndim
            for i, p in zip(self.inner, inner):
                pl[i] = p
            for i in self.agent_dims:
                p = ref.placements[i]
                pl[i] = p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            local = x.to_local() if is_sharded(x) else x
            return DTensor.from_local(local, self.mesh, pl, run_check=False)

        if is_sharded(like):
            return tree_map(lambda x: one(x, like), tree)
        return tree_map(one, tree, like)
