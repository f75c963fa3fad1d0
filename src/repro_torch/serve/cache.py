"""KV/SSM-cache layouts for serving, and per-slot cache surgery (a port of
``repro.serve.cache``).

``Backbone.init_cache`` allocates one batch-wide decode cache whose leaves
come in four kinds (all with arbitrary leading layer-stack dims):

  k/v    attention keys/values  (..., B, S, n_kv, head_dim)
         S = max_seq ("full" layout) or the sliding window W ("ring")
  pos    ring-buffer positions  (..., B, W) int32, -1 = empty slot
  ssm    Mamba2 recurrent state (..., B, n_heads, head_dim, d_state)
  conv_* causal-conv tail       (..., B, conv_kernel-1, channels)

This module formalizes those layouts (:class:`CacheLayout`), the bucketing
policy that bounds the prefill shapes (:func:`make_buckets` /
:func:`prefill_bucket`), and the one mutation the continuous batcher
needs: :func:`insert_slot`, which writes a single request's batch-1
prefill cache into slot ``b`` of the live batch cache, including the
full→ring conversion for windowed layers.

Where the reference builds a new cache tree, :func:`insert_slot` writes
the live cache in place and returns it: the engine owns its cache (the
reference donates it), and the captured decode tick reads it at fixed
addresses.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import full_tree, is_sharded
from repro_torch.models.config import ArchConfig
from repro_torch.tree import tree_leaves

# Where the batch dim sits in each cache-leaf kind (negative = from the end).
BATCH_AXIS = {"k": -4, "v": -4, "pos": -2, "ssm": -4,
              "conv_x": -3, "conv_b": -3, "conv_c": -3}
SEQ_AXIS = -3  # k/v only

# Families whose prefill carries recurrent state (SSM/conv tails) or
# capacity-limited routing: right-padding the prompt would corrupt the state
# (pad tokens flow through the recurrence) or perturb expert capacity, so
# these prefill at the exact prompt length instead of a padded bucket.
EXACT_PREFILL_FAMILIES = ("ssm", "hybrid", "moe")


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """What the batch cache holds per attention layer."""

    kind: str             # "full" | "ring"
    max_seq: int          # decode-cache capacity per slot (full layout)
    window: int = 0       # ring width for windowed layers (ring layout)

    @property
    def ring(self) -> bool:
        return self.kind == "ring"


def plan_layout(cfg: ArchConfig, max_seq: int, *, ring: bool = False) -> CacheLayout:
    """The layout ``Backbone(cfg, ring_cache=ring).init_cache(B, max_seq)``
    allocates.  Ring caches require sliding-window attention (a full-context
    layer cannot be O(W))."""
    if ring:
        if cfg.sliding_window <= 0:
            raise ValueError(
                f"{cfg.name}: ring caches need sliding_window > 0 "
                "(a full-attention layer cannot be window-bounded)")
        return CacheLayout("ring", max_seq, min(cfg.sliding_window, max_seq))
    return CacheLayout("full", max_seq)


def make_buckets(min_bucket: int, max_seq: int) -> tuple[int, ...]:
    """Power-of-two prompt-length ladder: min_bucket, 2·min_bucket, ...,
    capped at max_seq."""
    if min_bucket < 1 or max_seq < min_bucket:
        raise ValueError(f"bad bucket range [{min_bucket}, {max_seq}]")
    out = []
    b = min_bucket
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


def prefill_bucket(cfg: ArchConfig, prompt_len: int, buckets: tuple[int, ...]) -> int:
    """Padded prefill length for a prompt.  Attention-cache families pad up
    to the next bucket (decode masks the padded positions, and the first
    real decode write lands on top of the first pad slot); recurrent-state
    families must prefill exact-length — see EXACT_PREFILL_FAMILIES."""
    if cfg.family in EXACT_PREFILL_FAMILIES:
        return prefill_prefix(cfg, prompt_len)
    for b in buckets:
        if b >= prompt_len:
            return b
    raise ValueError(f"prompt of {prompt_len} tokens exceeds the largest "
                     f"bucket {buckets[-1]}")


def prefill_prefix(cfg: ArchConfig, prompt_len: int) -> int:
    """Longest prompt prefix an exact-length family can prefill in one shot:
    a multiple of ``ssm_chunk`` (SSM/hybrid: the chunked SSD scan) or of
    ``moe_group_size`` (MoE dispatch groups).  It can be 0 for very short
    prompts; the engine feeds the remaining prompt tokens through the
    shared decode step ("chunked prefill"), which threads the recurrent
    state exactly."""
    if cfg.family in ("ssm", "hybrid"):
        return (prompt_len // cfg.ssm_chunk) * cfg.ssm_chunk
    if cfg.family == "moe":
        return (prompt_len // cfg.moe_group_size) * cfg.moe_group_size
    return prompt_len


def ring_index_map(prompt_len: int, window: int, *, device=None):
    """(gather, pos) mapping a full-layout prefill cache into ring order.

    Ring slot ``s`` holds position ``p ≡ s (mod W)``; after a T-token
    prefill the live window is positions [max(T-W, 0), T).  ``gather``
    (int64) are the source sequence indices to read from the full cache
    (clipped in range; dead slots re-read position T-1 and are masked by
    ``pos``), and ``pos`` (int32) is the per-slot position row (-1 =
    empty)."""
    base = max(prompt_len - window, 0)
    s = torch.arange(window, device=device)
    src = base + torch.remainder(s - base, window)
    pos = torch.where(src < prompt_len, src, -1).to(torch.int32)
    return torch.clamp(src, max=prompt_len - 1), pos


def _slot_write(dst, src, slot, key):
    """Write ``src`` (batch dim of size 1) into batch index ``slot`` of
    ``dst`` in place; all other dims write from offset 0 (so a Tb-long
    prefill k/v fills the [0, Tb) prefix of a max_seq-long destination)."""
    axis = dst.dim() + BATCH_AXIS[key]
    region = [slice(0, n) for n in src.shape]
    region[axis] = slice(slot, slot + 1)
    if is_sharded(dst):
        _write_region_on_shards(dst, src, region)
        return dst
    dst[tuple(region)].copy_(src)
    return dst


def _write_region_on_shards(dst, src, region):
    """``dst[region] = src`` for a cache placed on a mesh: each rank writes
    the part of the region its own shard holds (a replica writes all of
    it), in place."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(dst.shape, dst.device_mesh,
                                                          dst.placements)
    dst_sl, src_sl = [], []
    for r, n, o in zip(region, shape, offset):
        lo, hi = max(r.start, o), min(r.stop, o + n)
        if lo >= hi:
            return
        dst_sl.append(slice(lo - o, hi - o))
        src_sl.append(slice(lo - r.start, hi - r.start))
    dst.to_local()[tuple(dst_sl)].copy_(src[tuple(src_sl)])


def _insert_attn_node(dst, src, slot, prompt_len):
    """One attention cache node ({"k","v"} or ring {"k","v","pos"}).  The
    source is the full-layout batch-1 cache prefill produced (or, for a
    ring destination, a fresh ring row); a ring destination consumes the
    full source's last-window suffix."""
    if "pos" in dst:
        if "pos" in src:
            # same (ring) layout on both sides — e.g. a fresh init_cache row
            # resetting the slot: write the rows straight through
            for key in dst:
                _slot_write(dst[key], src[key], slot, key)
            return dst
        W = dst["k"].shape[SEQ_AXIS]
        gather, pos = ring_index_map(prompt_len, W, device=src["k"].device)
        for key in ("k", "v"):
            row = torch.index_select(src[key], src[key].dim() + SEQ_AXIS, gather)
            _slot_write(dst[key], row, slot, key)
        posrow = pos.expand(tuple(dst["pos"].shape[:-2]) + (1, W))
        _slot_write(dst["pos"], posrow, slot, "pos")
        return dst
    for key in ("k", "v"):
        if src[key].shape[SEQ_AXIS] > dst[key].shape[SEQ_AXIS]:
            raise ValueError(
                f"prefill cache seq {src[key].shape[SEQ_AXIS]} exceeds the "
                f"batch cache capacity {dst[key].shape[SEQ_AXIS]}")
        _slot_write(dst[key], src[key], slot, key)
    return dst


def insert_slot(cache, request_cache, slot: int, *, prompt_len: int):
    """Write one request's batch-1 prefill cache into batch slot ``slot`` of
    the live cache, in place; returns ``cache``.  Attention nodes are
    handled as a unit (full→ring conversion needs k, v and pos together);
    ssm/conv state rows are written whole.  Everything the previous
    occupant (or idle decode garbage) left in positions the new request
    will attend to is overwritten; positions beyond the prompt stay masked
    until decode writes reach them."""
    if any(is_sharded(x) for x in tree_leaves(cache)):
        request_cache = full_tree(request_cache)   # every rank writes its own shard

    def walk(d, s, key=""):
        if isinstance(d, dict):
            if "k" in d and "v" in d:
                _insert_attn_node(d, s, slot, prompt_len)
            else:
                for k2 in d:
                    walk(d[k2], s[k2], k2)
        elif isinstance(d, (list, tuple)):
            for a, b in zip(d, s):
                walk(a, b, key)
        else:
            _slot_write(d, s, slot, key)

    walk(cache, request_cache)
    return cache
