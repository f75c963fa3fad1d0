"""Agent-grid collectives for FedGAN state (a port of
``repro.dist.collectives``).

FedGAN state is agent-stacked: every leaf carries a leading (P, A) grid.
The eq. (2) weighted mean over that grid runs through the fedavg kernel;
the compressed sync through the fused qsync kernel.  Both bucket a
subtree's leaves into one (B, N) buffer first, so a subtree costs one
launch however many leaves it has.  Results are broadcast back over the
grid (eq. (3)) as expanded views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg.kernel import fedavg_flat
from repro_torch.kernels.qsync import ops as qsync_ops
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

QPACK_SLICE = ("the composed coded sync needs the qpack kernels "
               "(quantize, dequantize, int4 pack), which the port has not "
               "ported yet")


def _inexact(x) -> bool:
    return x.is_floating_point() or x.is_complex()


def weighted_mean(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean of one (P, A, ...) leaf over its leading grid."""
    B = weights.numel()
    return fedavg_flat(weights, x.reshape(B, -1)).reshape(x.shape[2:])


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
    """The compressed intermediary sync of one subtree, fused path only:
    every float32 leaf of the subtree rides one bucketed qsync launch
    (uplink EF add, per-agent block quantize, weighted reduce, downlink
    residual, re-quantize).  Integer leaves pass through.

    Returns ``(synced, new_ef, new_ef_down)``; the residual trees are None
    when the corresponding input residuals are None.  ``fused=False``, a
    codec without a ``fused_sync_spec`` or a leaf the fused path cannot
    take raises ``NotImplementedError``: the composed per-leaf pipeline
    waits for the qpack kernels."""
    spec = codec.fused_sync_spec()
    if fused is False or spec is None:
        raise NotImplementedError(
            f"coded_sync(fused={fused}, codec={codec.name!r}): {QPACK_SLICE}; "
            "only the fused path (a codec with a fused_sync_spec) runs")
    leaves, treedef = tree_flatten(tree)
    e_leaves = tree_leaves(ef) if ef is not None else None
    ed_leaves = tree_leaves(ef_down) if ef_down is not None else None
    fuse_idx = []
    for i, x in enumerate(leaves):
        if qsync_ops.fusable_leaf(x):
            fuse_idx.append(i)
        elif _inexact(x):
            raise NotImplementedError(
                f"leaf {i} ({x.dtype}, shape {tuple(x.shape)}) cannot ride "
                f"the fused sync: {QPACK_SLICE}")
    outs = list(leaves)
    new_e = list(e_leaves) if ef is not None else None
    new_ed = list(ed_leaves) if ef_down is not None else None
    if fuse_idx:
        pick = lambda ls: [ls[i] for i in fuse_idx] if ls is not None else None
        f_out, f_ne, f_ned = qsync_ops.qsync_leaves(
            pick(leaves), weights, pick(e_leaves), pick(ed_leaves), **spec)
        for j, i in enumerate(fuse_idx):
            outs[i] = f_out[j]
            if new_e is not None:
                new_e[i] = f_ne[j]
            if new_ed is not None:
                new_ed[i] = f_ned[j]
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
