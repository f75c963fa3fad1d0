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
"""
from __future__ import annotations

import torch

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


def average_agents(tree, weights, *, sync_dtype=None):
    """Weighted average over the leading (P, A) dims, broadcast back.
    ``weights``: (P, A) float32, normalised.  ``sync_dtype`` (a torch
    dtype) casts each inexact leaf to that wire type for the reduce and the
    mean back to the leaf's type: the compressed sync.  Integer leaves (the
    Adam step count) are identical across lockstep agents and pass
    through.  One launch per wire dtype."""
    leaves, treedef = tree_flatten(tree)
    outs = list(leaves)
    groups: dict = {}
    for i, x in enumerate(leaves):
        if _inexact(x):
            groups.setdefault(sync_dtype or x.dtype, []).append(i)
    for wire, idx in groups.items():
        means = _bucketed_mean([leaves[i].to(wire) for i in idx], weights)
        for i, m in zip(idx, means):
            outs[i] = m.to(leaves[i].dtype).expand(leaves[i].shape)
    return tree_unflatten(treedef, outs)


def average_intra_pod(tree, weights):
    """Average within each pod only (tier 1 of hierarchical sync): the
    weighted mean over the A dim with each pod's weights renormalised,
    broadcast back over the pod.  Float32 leaves, bucketed into one pod
    launch; integer leaves pass through."""
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


def coded_sync(tree, weights, codec, *, ef=None, ef_down=None, fused=None):
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
    agent order with the same roundings, so they agree bit for bit."""
    spec = codec.fused_sync_spec()
    if fused is None:
        fused = spec is not None
    elif fused and spec is None:
        raise ValueError(f"fused=True needs a codec with a fused_sync_spec "
                         f"(got {codec.name!r})")
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
        m = weighted_mean(q, weights)
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
