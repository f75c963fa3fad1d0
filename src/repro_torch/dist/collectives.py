"""Agent-grid collectives for FedGAN state (a port of
``repro.dist.collectives``).

FedGAN state is agent-stacked: every leaf carries a leading (P, A) grid.
The eq. (2) weighted mean over that grid runs through the fedavg kernel.
The coded sync runs either fused, through the qsync kernel, or composed,
leaf by leaf through the codec (the qpack kernels) around the fedavg
reduce.  The plain average and the fused sync bucket a subtree's leaves
into one (B, N) buffer first, so a subtree costs one launch however many
leaves it has.  Results are broadcast back over the grid (eq. (3)) as
expanded views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg.kernel import fedavg_flat
from repro_torch.kernels.qsync import ops as qsync_ops
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def _inexact(x) -> bool:
    return x.is_floating_point() or x.is_complex()


def weighted_mean(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean of one (P, A, ...) leaf over its leading grid.  A
    broadcast leaf (the synced params are expanded views) is copied to the
    contiguous (B, N) the kernel takes."""
    B = weights.numel()
    return fedavg_flat(weights, x.reshape(B, -1).contiguous()).reshape(x.shape[2:])


def _bucketed_mean(leaves, weights):
    """The weighted mean of every leaf in ``leaves`` (one dtype), through
    one fedavg launch over their concatenation."""
    B = weights.numel()
    flat = [x.reshape(B, -1) for x in leaves]
    stacked = flat[0].contiguous() if len(flat) == 1 else torch.cat(flat, dim=1)
    m = fedavg_flat(weights, stacked)
    out, off = [], 0
    for x, f in zip(leaves, flat):
        n = f.shape[1]
        out.append(m[off:off + n].reshape(x.shape[2:]))
        off += n
    return out


def average_agents(tree, weights):
    """Weighted average over the leading (P, A) dims, broadcast back.
    ``weights``: (P, A) float32, normalised.  Integer leaves (the Adam step
    count) are identical across lockstep agents and pass through."""
    leaves, treedef = tree_flatten(tree)
    outs = list(leaves)
    groups: dict = {}
    for i, x in enumerate(leaves):
        if _inexact(x):
            groups.setdefault(x.dtype, []).append(i)
    for idx in groups.values():
        means = _bucketed_mean([leaves[i] for i in idx], weights)
        for i, m in zip(idx, means):
            outs[i] = m.expand(leaves[i].shape)
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


def sync_bytes(tree, *, codec=None) -> int:
    """Bytes one agent moves per direction in one parameter sync: the wire
    size of ``tree`` after the optional ``codec`` encoding (payload +
    scales); integer leaves pass through uncompressed."""
    total = 0
    for x in tree_leaves(tree):
        if codec is not None and _inexact(x):
            total += codec.wire_bytes(x)
        else:
            total += x.numel() * x.element_size()
    return total
