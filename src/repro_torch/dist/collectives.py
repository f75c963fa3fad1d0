"""Agent-grid collectives for FedGAN state (a port of
``repro.dist.collectives``).

FedGAN state is agent-stacked: every leaf carries a leading (P, A) grid.
The eq. (2) weighted mean over that grid runs through the fedavg kernel,
in the leaf's own type as the reference computes it: float32 leaves
through the float32 route, bfloat16 and float16 leaves (the wire of a
``sync_dtype`` cast) through the wire route, which rounds each product to
that type.  The per-pod mean of hierarchical sync runs through the pod
route.  The coded sync runs either fused, through the qsync kernel, or
composed, leaf by leaf through the codec (the qpack kernels) around the
fedavg reduce.  The plain average, the per-pod mean and the fused sync
bucket a subtree's leaves by dtype into one buffer first, so a subtree
costs one launch per dtype however many leaves it has.  Results are
broadcast back over the grid (eq. (3)) as expanded views.

Two more aggregates stand in for the weighted mean.  The Byzantine-robust
reduces (``make_robust_reduce``: a trimmed mean or the coordinate median)
sort the agents' values with PyTorch ops, as the reference sorts with XLA
ops, and launch no fedavg.  The secure sum (``masked_sync``) one-time-pads
each agent's uplink with pairwise masks drawn on the device (the tensor
Threefry of ``repro_torch.prng``) and ends in the fedavg reduce of the
unmasked products.

On a mesh (DTensor leaves, the agent grid sharded over ("pod", "data")),
the float32 weighted mean runs the fedavg kernel on each rank's own
agents, with the rank's slice of the globally normalised weights, and
sums the partial means across the ranks (``Partial(sum)`` to
``Replicate``).  Every other aggregate (the wire and pod routes, the
coded, robust and secure syncs) runs on inputs gathered from every rank,
as XLA runs a custom call it cannot partition, and each result is put
back with its input's placements.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.dist.sharding import full_tree, is_sharded
from repro_torch.kernels.fedavg.kernel import (fedavg_flat, fedavg_pod_flat,
                                               fedavg_wire_flat)
from repro_torch.kernels.qsync import ops as qsync_ops
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

# the reduce of a leaf of each type, as the reference's weighted_mean
# computes it in that type
_REDUCE = {torch.float32: fedavg_flat, torch.bfloat16: fedavg_wire_flat,
           torch.float16: fedavg_wire_flat}


def _inexact(x) -> bool:
    return x.is_floating_point() or x.is_complex()


def _reduce_for(dtype):
    try:
        return _REDUCE[dtype]
    except KeyError:
        raise NotImplementedError(
            f"the weighted mean in {dtype} (the reference's weighted_mean "
            f"in that type) is not ported; ported: float32, bfloat16, "
            f"float16") from None


def weighted_mean(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean of one (P, A, ...) leaf over its leading grid, in the
    leaf's type.  A broadcast leaf (the synced params are expanded views)
    is copied to the contiguous (B, N) the kernel takes."""
    B = weights.numel()
    return _reduce_for(x.dtype)(weights, x.reshape(B, -1).contiguous()).reshape(x.shape[2:])


def _split(m, leaves, lead):
    """The flat per-leaf segments of ``m`` (leading dims ``lead``),
    reshaped to each leaf's shape past the agent grid."""
    out, off = [], 0
    for x in leaves:
        n = x.shape[2:].numel()
        out.append(m[..., off:off + n].reshape(lead + tuple(x.shape[2:])))
        off += n
    return out


def _bucketed_mean(leaves, weights):
    """The weighted mean of every leaf in ``leaves`` (one dtype), through
    one launch over their concatenation."""
    B = weights.numel()
    flat = [x.reshape(B, -1) for x in leaves]
    stacked = flat[0].contiguous() if len(flat) == 1 else torch.cat(flat, dim=1)
    return _split(_reduce_for(stacked.dtype)(weights, stacked), leaves, ())


def _any_sharded(*trees) -> bool:
    return any(is_sharded(x) for t in trees if t is not None for x in tree_leaves(t))


def _place_like(tree, like):
    """Each leaf of ``tree`` (the same on every rank) put on the mesh with
    the placements of the matching DTensor leaf of ``like``; other leaves
    as they are."""
    if tree is None:
        return None
    from torch.distributed.tensor import distribute_tensor
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        distribute_tensor(x, ref.device_mesh, ref.placements, src_data_rank=None)
        if is_sharded(ref) else x for x, ref in zip(leaves, tree_leaves(like))])


def _agent_placements(x) -> tuple:
    """The placements of a (P, A, ...) DTensor leaf restricted to its agent
    dims: ``Shard(0)``/``Shard(1)`` kept, every other one ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                 for p in x.placements)


def _sum_over_agents(m):
    """The cross-rank sum of the partial means: every ``Partial`` mesh dim
    reduced to ``Replicate``."""
    from torch.distributed.tensor import Replicate
    return m.redistribute(m.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in m.placements))


def _mesh_means(leaves, weights):
    """The weighted means of float32 DTensor leaves (P, A, ...): on every
    rank one fedavg launch over its own agents' slices of all the leaves,
    then the cross-rank sum.  Returns DTensors shaped past the grid."""
    from torch.distributed.tensor import Partial, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    mesh, agent_pl = leaves[0].device_mesh, _agent_placements(leaves[0])
    if any(_agent_placements(x) != agent_pl for x in leaves):
        raise ValueError("the synced leaves shard their agent grid differently: "
                         f"{sorted({_agent_placements(x) for x in leaves}, key=str)}")
    w = distribute_tensor(weights.float(), mesh, agent_pl, src_data_rank=None)

    def out_placements(x):
        return tuple(Partial() if isinstance(p, Shard) and p.dim < 2 else
                     Shard(p.dim - 2) if isinstance(p, Shard) else p for p in x.placements)

    def local(wl, *xs):
        b = wl.numel()
        flat = [x.reshape(b, -1) for x in xs]
        stacked = flat[0].contiguous() if len(flat) == 1 else torch.cat(flat, dim=1)
        return tuple(_split(fedavg_flat(wl, stacked), xs, ()))

    parts = local_map(local, out_placements=tuple(out_placements(x) for x in leaves),
                      in_placements=(w.placements,) + tuple(x.placements for x in leaves),
                      device_mesh=mesh, redistribute_inputs=False)(w, *leaves)
    return [_sum_over_agents(m) for m in parts]


def _average_on_mesh(tree, weights):
    """``average_agents`` of a tree of DTensor leaves, float32 route."""
    leaves, treedef = tree_flatten(tree)
    outs = list(leaves)
    idx = [i for i, x in enumerate(leaves) if _inexact(x)]
    if idx:
        for i, m in zip(idx, _mesh_means([leaves[i] for i in idx], weights)):
            x = leaves[i]
            outs[i] = m.expand(x.shape).redistribute(x.device_mesh, x.placements)
    return tree_unflatten(treedef, outs)


def average_agents(tree, weights, *, sync_dtype=None, reduce=None):
    """Weighted average over the leading (P, A) dims, broadcast back.
    ``weights``: (P, A) float32, normalised.  ``sync_dtype`` (a torch
    dtype) casts each inexact leaf to that wire type for the reduce and the
    mean back to the leaf's type: the compressed sync.  Integer leaves (the
    Adam step count) are identical across lockstep agents and pass
    through.  One launch per wire dtype.

    ``reduce(x, weights) -> x.shape[2:]`` replaces the weighted mean leaf
    by leaf (a robust reduce of ``make_robust_reduce``); it launches no
    fedavg.

    On a mesh the float32 weighted mean is reduced rank by rank and summed
    across ranks; a wire type or a robust reduce runs on gathered inputs."""
    if _any_sharded(tree):
        if reduce is None and sync_dtype is None and all(
                x.dtype == torch.float32 for x in tree_leaves(tree) if _inexact(x)):
            return _average_on_mesh(tree, weights)
        return _place_like(average_agents(full_tree(tree), weights, sync_dtype=sync_dtype,
                                          reduce=reduce), tree)
    leaves, treedef = tree_flatten(tree)
    outs = list(leaves)
    if reduce is not None:
        for i, x in enumerate(leaves):
            if _inexact(x):
                m = reduce(x.to(sync_dtype) if sync_dtype is not None else x, weights)
                outs[i] = m.to(x.dtype).expand(x.shape)
        return tree_unflatten(treedef, outs)
    groups: dict = {}
    for i, x in enumerate(leaves):
        if _inexact(x):
            groups.setdefault(sync_dtype or x.dtype, []).append(i)
    for wire, idx in groups.items():
        means = _bucketed_mean([leaves[i].to(wire) for i in idx], weights)
        for i, m in zip(idx, means):
            outs[i] = m.to(leaves[i].dtype).expand(leaves[i].shape)
    return tree_unflatten(treedef, outs)


def make_robust_reduce(kind: str, *, trim: int = 1):
    """A ``reduce(x, weights)`` that tolerates Byzantine agents.

    ``"trimmed_mean"``: per coordinate, sort the B = P·A agent values,
    drop the ``trim`` smallest and largest, and average the rest: f <= trim
    corrupted agents (sign-flipped, scaled, NaN: NaN sorts last, into the
    trimmed tail) cannot move it outside the honest agents' range.
    ``"median"``: the per-coordinate lower median, the order statistic
    ``sorted[(B - 1) // 2]``, an honest value whenever f < B/2.  Never
    ``torch.median`` or ``nanmedian``: the first returns NaN when any agent
    is NaN, the second skips NaNs and shifts the order statistic.

    The sort is stable, with NaN last and -0 beside +0 in agent order, as
    the reference's ``jnp.sort``; so the median is the reference's bit for
    bit.  The trimmed mean sums its B - 2·trim rows in sorted order, one
    add at a time, and divides by their count held in a tensor (a division
    by a Python number multiplies by its reciprocal on the card): the same
    roundings on the card and the CPU.  Against the reference's
    ``jnp.mean``, which may group the sum otherwise, it is held within
    (B - 2·trim - 1) float32 roundings of the sum of the kept |values|,
    over their count, plus one rounding of the result.

    Robust aggregation ignores the weights (a poisoned agent could
    otherwise buy influence through a claimed dataset size)."""
    if kind not in ("trimmed_mean", "median"):
        raise ValueError(f"unknown robust reduce {kind!r}; "
                         "known: ['median', 'trimmed_mean']")

    def reduce(x, weights):
        B = x.shape[0] * x.shape[1]
        flat = torch.sort(x.reshape((B,) + tuple(x.shape[2:])), dim=0, stable=True).values
        if kind == "median":
            return flat[(B - 1) // 2]
        if B <= 2 * trim:
            raise ValueError(f"trimmed_mean needs more than 2*trim={2 * trim} "
                             f"agents, got {B}")
        acc = flat[trim]
        for b in range(trim + 1, B - trim):
            acc = acc + flat[b]
        return acc / torch.full((), B - 2 * trim, dtype=acc.dtype, device=acc.device)

    return reduce


def mask_pair_key(key: torch.Tensor, step) -> torch.Tensor:
    """The per-round mask key, ``fold_in(key, step)`` on ``key``'s device:
    from the fleet seed and the (checkpointed) step counter, so masks are
    never reused across rounds and a restored run draws them again."""
    return prng.fold_in_t(key, step)


def _accumulate_masks(keys: torch.Tensor, sizes, B: int) -> torch.Tensor:
    """Net pairwise masks of B agents over the concatenation of leaves of
    ``sizes`` elements, leaf l's bits drawn from ``keys[l]`` ((L, 2) int64
    key data): (B, sum(sizes)) int64 holding uint32.  m_i = sum_{j>i} r_ij
    - sum_{j<i} r_ji (mod 2^32), where pair p = (i, j), in the order i < j,
    draws r from ``fold_in(keys[l], p)``; summed over agents the r
    telescope to exactly 0.  The pairs are folded in one at a time, so the
    largest tensor is O(B·leaf), never the (B, B)·leaf pair tensor."""
    dev = keys.device
    n = sum(sizes)
    acc = torch.zeros((B, n), dtype=torch.int64, device=dev)
    if B < 2 or n == 0:
        return acc
    hi = torch.cat([prng.counters_t(k, dev)[0] for k in sizes])
    lo = torch.cat([prng.counters_t(k, dev)[1] for k in sizes])
    p = 0
    for i in range(B):
        for j in range(i + 1, B):
            pk = prng.fold_in_t(keys, p)
            k0 = torch.cat([pk[l, 0].expand(k) for l, k in enumerate(sizes)])
            k1 = torch.cat([pk[l, 1].expand(k) for l, k in enumerate(sizes)])
            y0, y1 = prng.threefry2x32_t(k0, k1, hi, lo)
            r = y0.bitwise_xor_(y1)
            acc[i].add_(r).bitwise_and_(prng._M32)
            acc[j].sub_(r).bitwise_and_(prng._M32)
            p += 1
    return acc


def _pairwise_masks(key: torch.Tensor, grid, shape) -> torch.Tensor:
    """Net uint32 pairwise masks of one leaf of ``shape`` on the (P, A)
    ``grid``, drawn from ``key`` ((2,) int64 key data): (P, A) + shape
    int64, as the reference's ``_pairwise_masks`` draws them."""
    P, A = grid
    n = int(torch.Size(shape).numel())
    return _accumulate_masks(key.reshape(1, 2), [n], P * A).reshape((P, A) + tuple(shape))


def _to_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its uint32 bit pattern, in int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & prng._M32


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns in int64 -> float32."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def _uplink(leaves, weights, key):
    """Per inexact leaf, each agent's weighted payload w_i·x_i, and the
    wire image of it: its uint32 bits plus the agent's net mask, mod 2^32;
    leaf i's masks drawn from ``fold_in(key, i)``.  Returns (indices of the
    inexact leaves, (B, n) products, (B, n) wire, (B, n) masks), n their
    total size."""
    idx = [i for i, x in enumerate(leaves) if _inexact(x)]
    for i in idx:
        if leaves[i].dtype != torch.float32:
            raise ValueError(
                f"masked_sync pads the 32-bit wire image; got {leaves[i].dtype} — "
                "cast the synced tree to float32 or drop secure_agg")
    B = weights.numel()
    if not idx:
        return idx, None, None, None
    w = weights.reshape(-1, 1)
    prods = torch.cat([leaves[i].reshape(B, -1) * w for i in idx], dim=1)
    every = prng.fold_in_t(key, torch.arange(len(leaves), device=key.device))
    leaf_keys = torch.cat([every[i:i + 1] for i in idx])
    masks = _accumulate_masks(leaf_keys, [leaves[i][0, 0].numel() for i in idx], B)
    wire = (_to_bits(prods) + masks) & prng._M32
    return idx, prods, wire, masks


def masked_wire(tree, weights, key):
    """The uplink wire images ``masked_sync`` ships for ``tree``: per
    inexact leaf a (P, A) + leaf int64 tensor of uint32 words (the bits of
    w_i·x_i plus agent i's net mask, mod 2^32); other leaves None."""
    leaves, treedef = tree_flatten(tree)
    idx, _, wire, _ = _uplink(leaves, weights, key)
    outs = [None] * len(leaves)
    for i, part in zip(idx, _split(wire, [leaves[i] for i in idx], (weights.numel(),))
                       if idx else []):
        outs[i] = part.reshape(leaves[i].shape)
    return tree_unflatten(treedef, outs)


def masked_sync(tree, weights, key, *, sync_dtype=None, reduce=None):
    """Secure-aggregation-style sum: every agent's wire image is one-time
    padded with pairwise PRG masks before it leaves the agent.

    Per inexact leaf, agent (p, a) folds its public weight into the payload
    first (weight-then-mask: a server that sees only masked payloads cannot
    weight them), then ships the uint32 bits of w_i·x_i plus its net
    pairwise mask, mod 2^32.  At the reduce the masks cancel exactly and
    the server sums the recovered products: ``average_agents`` with unit
    weights, one fedavg launch per subtree.  The products are already
    rounded and the kernel rounds each product before it adds in agent
    order, so the result is ``average_agents(tree, weights)`` bit for bit.

    The masks are drawn on ``key``'s device from ``key`` ((2,) int64 key
    data, fresh each round: ``mask_pair_key``); leaf i's from ``fold_in(key,
    i)``, pair p's from ``fold_in(that, p)``.  A robust ``reduce`` (order
    statistics need the values the sum hides) and a ``sync_dtype`` (a
    recast breaks the pad) are refused."""
    if _any_sharded(tree):
        return _place_like(masked_sync(full_tree(tree), weights, key, sync_dtype=sync_dtype,
                                       reduce=reduce), tree)
    if reduce is not None:
        raise ValueError(
            "masked_sync cannot apply a robust reduce: order statistics "
            "need the individual per-agent values a secure sum hides")
    if sync_dtype is not None:
        raise ValueError(
            "masked_sync pads the 32-bit wire image; a sync_dtype recast "
            "would break the pad cancellation — drop one of the two")
    leaves, treedef = tree_flatten(tree)
    idx, _, wire, masks = _uplink(leaves, weights, key)
    outs = list(leaves)
    if idx:
        B = weights.numel()
        recovered = _from_bits((wire - masks) & prng._M32)
        for i, part in zip(idx, _split(recovered, [leaves[i] for i in idx], (B,))):
            outs[i] = part.reshape(leaves[i].shape)
    return average_agents(tree_unflatten(treedef, outs), torch.ones_like(weights))


def average_intra_pod(tree, weights):
    """Average within each pod only (tier 1 of hierarchical sync): the
    weighted mean over the A dim with each pod's weights renormalised,
    broadcast back over the pod.  Float32 leaves, bucketed into one pod
    launch; integer leaves pass through.  On a mesh, on gathered inputs."""
    if _any_sharded(tree):
        return _place_like(average_intra_pod(full_tree(tree), weights), tree)
    leaves, treedef = tree_flatten(tree)
    outs = list(leaves)
    idx = [i for i, x in enumerate(leaves) if _inexact(x)]
    for i in idx:
        if leaves[i].dtype != torch.float32:
            raise NotImplementedError(
                f"average_intra_pod of a {leaves[i].dtype} leaf (the reference's "
                f"einsum in that type) is not ported; the pod route takes float32")
    if idx:
        P, A = weights.shape
        flat = [leaves[i].reshape(P, A, -1) for i in idx]
        stacked = flat[0].contiguous() if len(flat) == 1 else torch.cat(flat, dim=2)
        means = _split(fedavg_pod_flat(weights, stacked), [leaves[i] for i in idx], (P,))
        for i, m in zip(idx, means):
            outs[i] = m[:, None].expand(leaves[i].shape)
    return tree_unflatten(treedef, outs)


def coded_sync(tree, weights, codec, *, ef=None, ef_down=None, reduce=None, fused=None):
    """The compressed intermediary sync of one subtree.

    Per inexact leaf: the agent adds its residual (``ef``), encodes through
    ``codec`` (the uplink wire image; blocks and top-k never span agents),
    the intermediary decodes and takes the weighted mean over (P, A), adds
    its own residual (``ef_down``), re-encodes the mean (the downlink wire
    image) and broadcasts it back.  Integer leaves pass through.

    Returns ``(synced, new_ef, new_ef_down)``; the residual trees are None
    when the corresponding input residuals are None.

    ``fused``: None (the default) sends the float32 leaves through one
    bucketed qsync launch when the codec has a ``fused_sync_spec``; False
    runs every leaf through the composed pipeline (the codec's roundtrip,
    i.e. the qpack kernels, around one fedavg launch per leaf); True
    requires the fused path and raises ``ValueError`` for a codec without
    a spec.  Leaves the fused kernel cannot take (not float32) fall back to
    the composed pipeline leaf by leaf.  On the card both paths reduce in
    agent order with the same roundings, so they agree bit for bit.

    ``reduce`` (a robust reduce of ``make_robust_reduce``) takes the
    weighted mean's place on the decoded per-agent wire images; it runs on
    the composed path only (no fedavg launch), so ``fused=True`` refuses
    it and the default then composes."""
    spec = codec.fused_sync_spec()
    fusable = spec is not None and reduce is None
    if fused is None:
        fused = fusable
    elif fused and not fusable:
        raise ValueError(
            f"fused=True needs a codec with a fused_sync_spec (got {codec.name!r}) "
            "and the default weighted-mean reduce" if reduce is None else
            "fused=True cannot apply a custom reduce: the fused kernel "
            "hard-wires the weighted mean")
    if _any_sharded(tree, ef, ef_down):
        # the codec re-encodes after the global reduce: gathered inputs
        out, e2, ed2 = coded_sync(full_tree(tree), weights, codec, ef=full_tree(ef),
                                  ef_down=full_tree(ef_down), reduce=reduce, fused=fused)
        return _place_like(out, tree), _place_like(e2, ef), _place_like(ed2, ef_down)
    leaves, treedef = tree_flatten(tree)
    e_leaves = tree_leaves(ef) if ef is not None else [None] * len(leaves)
    ed_leaves = tree_leaves(ef_down) if ef_down is not None else [None] * len(leaves)
    outs, new_e, new_ed = list(leaves), list(e_leaves), list(ed_leaves)
    fuse_idx = [i for i, x in enumerate(leaves)
                if fused and qsync_ops.fusable_leaf(x)]
    fuse_set = set(fuse_idx)
    for i, (x, e, ed) in enumerate(zip(leaves, e_leaves, ed_leaves)):
        if i in fuse_set or not _inexact(x):
            continue
        y = x + e if e is not None else x
        q = codec.roundtrip(y, batch_ndims=2)            # uplink wire image
        m = weighted_mean(q, weights) if reduce is None else reduce(q, weights)
        yd = m + ed if ed is not None else m
        qd = codec.roundtrip(yd)                         # downlink wire image
        outs[i] = qd.to(x.dtype).expand(x.shape)
        new_e[i] = y - q if e is not None else None
        new_ed[i] = yd - qd if ed is not None else None
    if fuse_idx:
        pick = lambda ls: [ls[i] for i in fuse_idx]
        f_out, f_ne, f_ned = qsync_ops.qsync_leaves(
            pick(leaves), weights, pick(e_leaves) if ef is not None else None,
            pick(ed_leaves) if ef_down is not None else None, **spec)
        for j, i in enumerate(fuse_idx):
            outs[i], new_e[i], new_ed[i] = f_out[j], f_ne[j], f_ned[j]
    return (tree_unflatten(treedef, outs),
            tree_unflatten(treedef, new_e) if ef is not None else None,
            tree_unflatten(treedef, new_ed) if ef_down is not None else None)


def tree_bytes(tree) -> int:
    """Total bytes of the tensor leaves (the 'M' of the §3.2 accounting)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def sync_bytes(tree, *, sync_dtype=None, codec=None) -> int:
    """Bytes one agent moves per direction in one parameter sync: the wire
    size of ``tree`` after the optional ``sync_dtype`` cast or ``codec``
    encoding (payload + scales); integer leaves pass through uncompressed
    by a codec."""
    if sync_dtype is not None and codec is not None:
        raise ValueError("sync_dtype and codec are both wire compressions; "
                         "pick one")
    total = 0
    for x in tree_leaves(tree):
        if codec is not None and _inexact(x):
            total += codec.wire_bytes(x)
            continue
        itemsize = sync_dtype.itemsize if sync_dtype is not None else x.element_size()
        total += x.numel() * itemsize
    return total
