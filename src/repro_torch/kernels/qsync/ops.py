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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.qpack.ops import _check
from repro_torch.kernels.qsync import kernel


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
