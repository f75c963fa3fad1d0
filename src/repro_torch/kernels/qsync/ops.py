"""Public entry points for the fused coded sync.

``qsync_flat`` runs one agent-stacked flat stream of any length through the
kernel: it pads to the block multiple and trims the padding on the way
out.  ``qsync_leaves`` buckets a subtree: every float32 leaf of the
(P, A)-stacked group is flattened to (B, n_i), padded PER LEAF to the block
multiple and concatenated into one (B, N_flat) buffer, so syncing a whole
subtree is one launch.  Padding each leaf before concatenating keeps every
leaf's block boundaries, so the quantizer sees exactly the tiles of the
per-leaf pipeline, and the zero pad lanes neither move a block's max-abs
nor survive the trim.

``adam_sync_flat`` / ``adam_sync_tree`` run the K-th local Adam step of
every agent fused with the uplink quantize of its new parameters (the
second kernel of ``csrc/qsync.cu``), on one flat stream or on a bucketed
tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.qpack.ops import _check
from repro_torch.kernels.qsync import kernel
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def qsync_flat(weights, stacked, ef=None, ef_down=None, *, bits: int = 8,
               block: int = 128):
    """Fused coded sync of one flat stream: ``weights`` shaped like the
    agent grid, ``stacked`` (B, n) float32 (any n), optional uplink residual
    ``ef`` (B, n) and downlink residual ``ef_down`` (n,).  Returns
    ``(synced (n,), new_ef | None, new_ef_down | None)``."""
    _check(bits, block)
    qmax = 2 ** (bits - 1) - 1
    n = stacked.shape[1]
    pad = (-n) % block
    if pad:
        stacked = F.pad(stacked, (0, pad))
        ef = F.pad(ef, (0, pad)) if ef is not None else None
        ef_down = F.pad(ef_down, (0, pad)) if ef_down is not None else None
    synced, ne, ned = kernel.qsync_flat(weights, stacked, ef, ef_down,
                                        qmax=qmax, block=block)
    return (synced[:n],
            ne[:, :n] if ne is not None else None,
            ned[:n] if ned is not None else None)


def fusable_leaf(x) -> bool:
    """Whether a leaf can ride the fused path: (P, A)-stacked float32."""
    return isinstance(x, torch.Tensor) and x.dtype == torch.float32 and x.dim() >= 2


def _bucket(leaves, B: int, block: int):
    """[(B, ...)] -> one (B, N_flat) buffer + per-leaf (offset, n) spans,
    each leaf padded to its own block multiple before concatenation."""
    cols, spans, off = [], [], 0
    for x in leaves:
        flat = x.reshape(B, -1)
        n = flat.shape[1]
        pad = (-n) % block
        cols.append(F.pad(flat, (0, pad)) if pad else flat)
        spans.append((off, n))
        off += n + pad
    return (cols[0].contiguous() if len(cols) == 1 else torch.cat(cols, dim=1),
            spans)


def qsync_leaves(leaves, weights, ef_leaves=None, ef_down_leaves=None, *,
                 bits: int = 8, block: int = 128):
    """Bucketed fused sync of a group of (P, A, ...) float32 leaves: one
    launch for the whole group.  ``ef_leaves`` match the leaves' shapes,
    ``ef_down_leaves`` their per-agent shapes (``leaf.shape[2:]``).
    Returns ``(synced, new_ef, new_ef_down)`` leaf lists; synced leaves are
    broadcast back over the agent grid."""
    _check(bits, block)
    B = weights.numel()
    stacked, spans = _bucket(leaves, B, block)
    ef = _bucket(ef_leaves, B, block)[0] if ef_leaves is not None else None
    ef_down = None
    if ef_down_leaves is not None:
        ef_down = _bucket([e[None] for e in ef_down_leaves], 1, block)[0][0]
    synced, ne, ned = qsync_flat(weights, stacked, ef, ef_down, bits=bits,
                                 block=block)
    outs, new_e, new_ed = [], [], []
    for x, (off, n) in zip(leaves, spans):
        outs.append(synced[off:off + n].reshape(x.shape[2:]).expand(x.shape))
        new_e.append(ne[:, off:off + n].reshape(x.shape)
                     if ne is not None else None)
        new_ed.append(ned[off:off + n].reshape(x.shape[2:])
                      if ned is not None else None)
    return outs, new_e, new_ed


def adam_sync_flat(params, grads, mu, nu, *, lr, count, b1: float = 0.5,
                   b2: float = 0.999, eps: float = 1e-8, bits: int = 8,
                   block: int = 128):
    """Fused Adam step + uplink wire cast over (B, n) float32 params.
    ``count`` is the pre-increment step counter (``opt_state["count"]``, a
    0-d integer tensor on the params' device); ``lr`` a float or a 0-d
    tensor.  The bias corrections are computed here, on ``count``'s device,
    by the same torch operations as ``optim.Adam.update``, so the kernel,
    its plain version and ``Adam.update`` divide by the same two numbers.
    Returns ``(new_params (B, n), new_mu, new_nu, codes int8 (B, Np),
    scales f16 (B, Np // block))``: codes and scales keep the padded lanes,
    as ``qpack.ops.quantize_blocks`` does."""
    _check(bits, block)
    qmax = 2 ** (bits - 1) - 1
    c = (count + 1).to(torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=c.device).reshape(())
    hyper = torch.stack([lr, 1.0 - b1 ** c, 1.0 - b2 ** c]).reshape(1, 3)
    n = params.shape[1]
    pad = (-n) % block
    if pad:
        params, grads, mu, nu = (F.pad(a, (0, pad)) for a in (params, grads, mu, nu))
    p2, mu2, nu2, q, s = kernel.adam_sync_flat(hyper, params, grads, mu, nu,
                                               b1=b1, b2=b2, eps=eps, qmax=qmax,
                                               block=block)
    return p2[:, :n], mu2[:, :n], nu2[:, :n], q, s


def adam_sync_tree(params, grads, opt_state, *, lr, b1: float = 0.5,
                   b2: float = 0.999, eps: float = 1e-8, bits: int = 8,
                   block: int = 128):
    """Tree form: every (B, ...) float32 leaf of ``params``, ``grads`` and
    the Adam moments is bucketed into one (B, N_flat) buffer (each leaf
    padded to its own block multiple) and the step runs as ONE launch.
    Returns ``(new_params, new_opt_state, codes, scales)``: the trees
    mirror the inputs, ``new_opt_state["count"]`` is ``count + 1``, and
    codes and scales are the uplink wire image of the bucketed stream."""
    leaves, treedef = tree_flatten(params)
    B = leaves[0].shape[0]
    bucket = lambda tree: _bucket(tree_leaves(tree), B, block)[0]
    p, spans = _bucket(leaves, B, block)
    p2, mu2, nu2, q, s = adam_sync_flat(
        p, bucket(grads), bucket(opt_state["mu"]), bucket(opt_state["nu"]),
        lr=lr, count=opt_state["count"], b1=b1, b2=b2, eps=eps, bits=bits,
        block=block)

    def split(flat):
        return tree_unflatten(treedef, [flat[:, off:off + n].reshape(x.shape)
                                        for x, (off, n) in zip(leaves, spans)])

    new_state = {"count": opt_state["count"] + 1, "mu": split(mu2), "nu": split(nu2)}
    return split(p2), new_state, q, s
