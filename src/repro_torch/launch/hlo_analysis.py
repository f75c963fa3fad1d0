"""Collective and cost accounting of a built step (the twin of
``repro.launch.hlo_analysis``).

The reference parses the post-SPMD HLO of a compiled step.  The port has
no HLO: it runs the step once under a ``TorchDispatchMode`` and counts
what DTensor dispatches.  The mode lets every DTensor op through to
DTensor (it returns ``NotImplemented`` on a DTensor, as
``torch.distributed.tensor.debug.CommDebugMode`` does), so it sees the
local aten ops and the ``_c10d_functional`` collectives DTensor turns
each op into: its redistributions, and the port's manual agent reduce
(a ``Partial`` -> ``Replicate`` redistribute over the agent axes,
``repro_torch.dist.collectives._sum_over_agents``).  Every collective's
process group is mapped back to the mesh axes it spans, by its ranks'
coordinates in the mesh.

  * collectives: each contributes its OUTPUT bytes on this rank (the
    reference's wire-bytes proxy), by mesh axis;
  * FLOPs: ``torch.utils.flop_counter``'s registry (the counts
    ``FlopCounterMode`` reports: matmuls, convolutions, attention) over
    the local ops, so per rank;
  * bytes: the operand and result bytes of every aten op that is not a
    view: an upper bound, since nothing is fused (the reference counts
    XLA's fusions once at their boundary);
  * memory: every storage an op makes is live until it is freed (a weak
    reference on it); ``peak_bytes`` is the high-water mark of what the
    call itself holds, its arguments not included.  An op makes the
    storage of an output that is not a view, not a return its schema
    aliases to an argument (in place, ``out=``) and not an argument's
    storage (``_unsafe_view``): a view or an in-place result of an
    argument allocates nothing.

A step may run on real tensors, or on fake ones (``FakeTensorMode``) to
count a full-size step without allocating it.  ``in_loop`` marks what is
issued inside the round's K local steps (``FedGAN._step``, gradient
hooks included) or a segment sync: the ops of the reference's K-step
scan body, which ``skip_loops`` drops.  Shapes are each rank's local
shards, so every total is per rank, as the roofline terms need.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

# bits of the sub-byte dtypes: an n-element buffer is ceil(n * bits / 8)
# bytes, not n (torch reports an element size of 1 for them)
_SUB_BYTE_BITS = {getattr(torch, f"{s}int{b}"): b for s in ("u", "") for b in range(1, 8)
                  if hasattr(torch, f"{s}int{b}")}


def tensor_bytes(t) -> int:
    """Bytes of a tensor's elements (of a DTensor: its local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    n = t.numel()
    bits = _SUB_BYTE_BITS.get(t.dtype)
    if bits is not None:
        return (n * bits + 7) // 8
    return n * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a tree (local shards of DTensors)."""
    from torch.utils._pytree import tree_leaves
    return sum(tensor_bytes(x) for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def _collective_kind(packet) -> str | None:
    """all_reduce | all_gather | reduce_scatter | all_to_all | broadcast for
    a collective op (functional, autograd-functional or c10d), else None."""
    name = packet._qualified_op_name
    ns, _, op = name.partition("::")
    if ns not in ("_c10d_functional", "_c10d_functional_autograd", "c10d"):
        return None
    op = op.rstrip("_")
    if op.startswith(("all_reduce", "allreduce")):
        return "all_reduce"
    if op.startswith(("all_gather", "allgather", "_allgather")):
        return "all_gather"
    if op.startswith(("reduce_scatter", "_reduce_scatter")):
        return "reduce_scatter"
    if op.startswith(("all_to_all", "alltoall")):
        return "all_to_all"
    if op.startswith(("broadcast", "scatter")):
        return "broadcast"
    return None


# ---------------------------------------------------------------------------
# the round's loop context and the source anchor
# ---------------------------------------------------------------------------


def _loop_codes() -> frozenset:
    """Code objects whose frames are the round's K-step loop body."""
    from repro_torch.core import strategies
    from repro_torch.core.fedgan import FedGAN
    codes = {FedGAN._step.__code__}
    stack = [strategies.SyncStrategy]
    while stack:
        cls = stack.pop()
        stack.extend(cls.__subclasses__())
        fn = cls.__dict__.get("segment_sync")
        if fn is not None and cls is not strategies.SyncStrategy:
            codes.add(fn.__code__)
    return frozenset(codes)


def in_round_loop(codes: frozenset | None = None) -> bool:
    """Whether the caller runs inside a round's K local steps or one of its
    segment syncs."""
    codes = _loop_codes() if codes is None else codes
    f = sys._getframe(1)
    while f is not None:
        if f.f_code in codes:
            return True
        f = f.f_back
    return False


_HERE = os.path.dirname(os.path.abspath(__file__))
_MACHINERY = (os.path.join(os.path.dirname(_HERE), "analysis") + os.sep,
              os.path.abspath(__file__))


def source_anchor(root: str, frame=None) -> tuple:
    """(path relative to ``root``, line) of the innermost frame of the
    stack from ``frame`` (default: the caller's) outward whose file lies
    under ``root`` and is not this accounting's own machinery; ("", 0)
    when none does."""
    root = os.path.abspath(root) + os.sep
    f = sys._getframe(1) if frame is None else frame
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(root) and not path.startswith(_MACHINERY[0]) \
                and path != _MACHINERY[1]:
            return os.path.relpath(path, root).replace(os.sep, "/"), f.f_lineno
        f = f.f_back
    return "", 0


# ---------------------------------------------------------------------------
# records and their aggregate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as dispatched on this rank: what the reference's
    record of one HLO collective op holds, with the mesh axes named."""

    op: str                    # all_reduce | all_gather | reduce_scatter | ...
    bytes: int                 # output bytes on this rank (the wire proxy)
    mesh_axes: tuple           # mesh axes the group spans, () when unknown
    operand_dtypes: tuple      # torch dtype names of the inputs, in order
    in_loop: bool              # issued inside the round's K local steps?
    group_size: int = 0
    source_file: str = ""      # innermost frame under the root
    source_line: int = 0

    @property
    def group_signature(self) -> str:
        """The mesh axes the group spans ("data", "pod+data", "model"), or
        its size when it maps to no axis of the mesh."""
        return "+".join(self.mesh_axes) if self.mesh_axes else f"group{self.group_size}"


def _axis_class(axes: tuple, mesh_dims: dict | None) -> str:
    if not axes or (mesh_dims is not None and any(a not in mesh_dims for a in axes)):
        return "other"
    if set(axes) <= {"pod", "data"}:
        return "agent"
    if axes == ("model",):
        return "model"
    return "other"


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict
    bytes_by_group: dict   # group signature (mesh axes) -> bytes

    @classmethod
    def from_records(cls, records, *, skip_loops: bool = False) -> "CollectiveStats":
        by_op, cnt, by_g = defaultdict(int), defaultdict(int), defaultdict(int)
        for r in records:
            if skip_loops and r.in_loop:
                continue
            by_op[r.op] += r.bytes
            cnt[r.op] += 1
            by_g[r.group_signature] += r.bytes
        return cls(dict(by_op), dict(cnt), dict(by_g))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def bytes_by_axis(self, mesh_dims: dict) -> dict:
        """Traffic by mesh axis: groups over the agent axes ("pod",
        "data" or both) are the cross-agent wire, groups over "model"
        the tensor parallelism inside an agent; any other group (several
        kinds of axes, or none of this mesh's) lands in "other"."""
        out = {"model": 0, "agent": 0, "other": 0}
        for sig, b in self.bytes_by_group.items():
            axes = () if sig.startswith("group") else tuple(sig.split("+"))
            out[_axis_class(axes, mesh_dims)] += b
        return out

    def summary(self) -> dict:
        return {"total_bytes": self.total_bytes, "by_op_bytes": dict(self.bytes_by_op),
                "by_op_count": dict(self.count_by_op),
                "by_group": dict(self.bytes_by_group)}


# ---------------------------------------------------------------------------
# the dispatch mode
# ---------------------------------------------------------------------------


_SHARDING_PROP = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_SHARDING_PROP):
            return True
        f = f.f_back
    return False


def active_fake_mode():
    """The innermost ``FakeTensorMode`` on the dispatch mode stack, or None."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, FakeTensorMode):
            return m
    return None


class DispatchCount(TorchDispatchMode):
    """Counts one call's collectives, FLOPs and operand bytes (module
    docstring).  ``mesh`` maps process groups to its axis names; ``root``
    anchors each collective at its source line."""

    def __init__(self, mesh=None, root: str | None = None):
        super().__init__()
        from repro_torch.analysis.lint import repo_root_from_package
        from torch.utils.flop_counter import flop_registry
        self.root = root or repo_root_from_package()
        self.records: list = []
        self.flops = 0
        self.hbm_bytes = 0
        self.op_count = 0
        self._flop_registry = flop_registry
        self._codes = _loop_codes()
        self._groups: dict = {}
        self._fake_on_entry = None
        self._live = WeakIdKeyDictionary()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._coords = {}
        self._names = ()
        if mesh is not None:
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            self._names = tuple(mesh.mesh_dim_names)
            with unset_fake_temporarily():   # the mesh's rank table is a real tensor
                ranks = mesh.mesh.tolist()
            for idx in _indices(tuple(mesh.shape)):
                r = ranks
                for i in idx:
                    r = r[i]
                self._coords[r] = idx

    def _group_axes(self, group) -> tuple:
        """(mesh axes, size) of a group given by name or object."""
        from torch.distributed import distributed_c10d as c10d
        key = group if isinstance(group, str) else getattr(group, "group_name", id(group))
        hit = self._groups.get(key)
        if hit is None:
            pg = c10d._resolve_process_group(group) if isinstance(group, str) else group
            try:
                ranks = c10d.get_process_group_ranks(pg)
            except (KeyError, RuntimeError, ValueError):
                ranks = list(range(pg.size()))
            coords = [self._coords.get(r) for r in ranks]
            axes = ()
            if coords and all(c is not None for c in coords):
                axes = tuple(n for d, n in enumerate(self._names)
                             if len({c[d] for c in coords}) > 1)
            hit = self._groups[key] = (axes, len(ranks))
        return hit

    def _record(self, kind, args, out):
        from torch.utils._pytree import tree_leaves
        group = None
        for a in list(args)[::-1]:
            if isinstance(a, str) or hasattr(a, "group_name"):
                group = a
                break
        axes, size = self._group_axes(group) if group is not None else ((), 0)
        ins = [x for x in tree_leaves(list(args)) if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        f, line = source_anchor(self.root)
        self.records.append(CollectiveRecord(
            op=kind, bytes=sum(tensor_bytes(x) for x in outs), mesh_axes=axes,
            operand_dtypes=tuple(str(x.dtype).replace("torch.", "") for x in ins),
            in_loop=in_round_loop(self._codes), group_size=size,
            source_file=f, source_line=line))

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor lower it to local ops first
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_on_entry or _in_propagation():
            # DTensor's sharding propagation runs ops on global shapes under
            # a fake mode (its own, or the caller's) once a signature and
            # caches the result: not the rank's work
            return out
        from torch.utils._pytree import tree_leaves
        packet = func._overloadpacket
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        for x in _made(func, args, kwargs, out):
            self._track(x)
        kind = _collective_kind(packet)
        if kind is not None:
            self._record(kind, args, out)
            return out
        if packet is torch.ops._c10d_functional.wait_tensor or func.is_view:
            return out
        self.op_count += 1
        count = self._flop_registry.get(packet)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        self.hbm_bytes += sum(tensor_bytes(x) for x in tree_leaves((args, kwargs))
                              if isinstance(x, torch.Tensor)) + sum(map(tensor_bytes, outs))
        return out

    def _track(self, t) -> None:
        """Count a storage an op made as allocated until it is freed:
        ``live_bytes`` and its high-water mark ``peak_bytes``."""
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n


def _made(func, args, kwargs, out) -> list:
    """The output tensors of ``func`` whose storage the op made: none of a
    view op, no return its schema aliases to an argument (in place,
    ``out=``), and no output on an argument's storage."""
    from torch.utils._pytree import tree_leaves
    if func.is_view:
        return []
    rets = func._schema.returns
    parts = (out,) if len(rets) == 1 else tuple(out)
    given = {id(x.untyped_storage()) for x in tree_leaves((args, kwargs))
             if isinstance(x, torch.Tensor)}
    return [x for r, part in zip(rets, parts) if r.alias_info is None
            for x in tree_leaves(part)
            if isinstance(x, torch.Tensor) and id(x.untyped_storage()) not in given]


def _indices(shape):
    out = [()]
    for n in shape:
        out = [i + (k,) for i in out for k in range(n)]
    return out


def count_dispatch(fn, *args, mesh=None, root=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`DispatchCount`:
    returns (its output, the counts)."""
    mode = DispatchCount(mesh, root)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode


def collective_records(fn, *args, mesh=None, root=None, **kwargs) -> list:
    """Every collective one call of ``fn`` dispatches, in order: op,
    output bytes, mesh axes, operand dtypes, loop context and source
    line (records per occurrence, as the reference's)."""
    return count_dispatch(fn, *args, mesh=mesh, root=root, **kwargs)[1].records


def collective_bytes(source, *args, mesh=None, skip_loops: bool = False,
                     **kwargs) -> CollectiveStats:
    """Collective bytes of one call of ``source`` (a function, run on
    ``args``), or of a list of :class:`CollectiveRecord`.  ``skip_loops``
    drops what is issued inside the K local steps: what is left is the
    once-a-round traffic (the round's parameter sync)."""
    records = source if isinstance(source, (list, tuple)) else \
        collective_records(source, *args, mesh=mesh, **kwargs)
    return CollectiveStats.from_records(records, skip_loops=skip_loops)


def program_costs(fn, *args, **kwargs) -> dict:
    """{"flops", "hbm_bytes", "op_count"} of one call of ``fn`` per rank:
    FLOPs by ``torch.utils.flop_counter``'s registry over the local ops,
    bytes the operands and results of every non-view op (an upper bound:
    nothing is fused)."""
    _, mode = count_dispatch(fn, *args, **kwargs)
    return {"flops": mode.flops, "hbm_bytes": mode.hbm_bytes, "op_count": mode.op_count}
