"""Transformer building blocks: RoPE, GQA attention (full-sequence and
cache decode), SwiGLU, norms (a port of ``repro.models.layers``).

Parameters keep the reference's keys and layouts (Dense ``w`` is
``(in, out)``).  The reference's sharding constraints stand at the same
places (``repro_torch.dist.sharding.shard``: the identity without a mesh);
under a mesh attention (the flash kernel or the plain route) runs on
local shards with the keys' sequence and head_dim whole, split by heads,
then batch, then (the plain route) query rows; a decode keeps its cache
where it is sharded, by its keys or by head_dim (``_attend_on_shards``).
Cross-attention (the audio family's
decoder over the encoder's memory) takes its queries from x and its keys
and values from the memory, with no RoPE, no qk-norm and no mask, always
through ``_sdpa``, as the reference's.

Both decodes take ``donate``: the port's counterpart of the reference
engine donating its cache to the compiled decode.  With ``donate=True``
the new token's k/v (and ring position) are written into the given cache
in place and that cache is returned, so a serving tick copies no cache.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.dist.sharding import (batch_spec, is_sharded, local_kernel, pin_grad,
                                       shard, shard_attn_qkv, whole_dims)
from repro_torch.models.config import ArchConfig

NEG_INF = -2.0 ** 30  # large-but-finite mask value (NaN-safe under softmax)


def decode_positions(index, batch: int, device=None) -> torch.Tensor:
    """Normalize a decode index — scalar () or per-row (B,) — to (B,) int64.

    The scalar form is the lockstep case (every row writes the same cache
    position); the vector form is what continuous batching needs, where each
    batch slot sits at its own sequence position."""
    idx = torch.as_tensor(index, device=device).long()
    if idx.dim() == 0:
        idx = idx.expand(batch)
    return idx


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., T, D/2)
    angles = angles[..., None, :]                               # (..., T, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Norm factory
# ---------------------------------------------------------------------------

def make_norm(cfg: ArchConfig, dim: int) -> nn.Module:
    if cfg.norm == "layernorm":
        return nn.LayerNorm(dim, dtype=cfg.param_dtype)
    return nn.RMSNorm(dim, dtype=cfg.param_dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Attention(nn.Module):
    """Grouped-query attention with RoPE, optional qk-norm and sliding window.

    Modes:
      full-sequence  apply(params, x, *, window, positions) -> y
      decode         decode(params, x1, cache, index, *, window) -> y1, cache'
      ring decode    decode_ring(params, x1, cache, index) -> y1, cache'
    KV cache layout: (B, S, n_kv, head_dim) per layer (stacked outside);
    a ring cache (``init_cache(ring=True)``) adds ``pos`` (B, W) int32.
    ``use_flash`` routes the full-sequence path through the flash-attention
    kernel.
    """

    cfg: ArchConfig
    causal: bool = True
    use_flash: bool = False

    @property
    def dims(self):
        c = self.cfg
        return c.num_heads, c.num_kv_heads, c.resolved_head_dim

    def init(self, gen):
        c = self.cfg
        nh, nkv, hd = self.dims
        d = c.d_model
        p = {
            "wq": nn.Dense(d, nh * hd, use_bias=False, dtype=c.param_dtype).init(gen),
            "wk": nn.Dense(d, nkv * hd, use_bias=False, dtype=c.param_dtype).init(gen),
            "wv": nn.Dense(d, nkv * hd, use_bias=False, dtype=c.param_dtype).init(gen),
            "wo": nn.Dense(nh * hd, d, use_bias=False, dtype=c.param_dtype).init(gen),
        }
        if c.qk_norm:
            p["q_norm"] = nn.RMSNorm(hd, dtype=c.param_dtype).init(gen)
            p["k_norm"] = nn.RMSNorm(hd, dtype=c.param_dtype).init(gen)
        return p

    # -- shared projection helpers ------------------------------------------------
    def _qkv(self, params, x, positions):
        c = self.cfg
        nh, nkv, hd = self.dims
        q = _split_heads(x @ params["wq"]["w"].to(c.dtype), nh, hd)
        k = _split_heads(x @ params["wk"]["w"].to(c.dtype), nkv, hd)
        v = _split_heads(x @ params["wv"]["w"].to(c.dtype), nkv, hd)
        if c.qk_norm:
            q = nn.RMSNorm(hd).apply(params["q_norm"], q)
            k = nn.RMSNorm(hd).apply(params["k_norm"], k)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        return q, k, v

    def _memory_kv(self, params, memory):
        """Cross-attention keys and values of the encoder's memory (B, S, d),
        or of a pair (the values' memory, the keys'): the remat op takes the
        memory once per use, so that its gradient is summed use by use as
        without remat."""
        c = self.cfg
        _, nkv, hd = self.dims
        mv, mk = memory if isinstance(memory, tuple) else (memory, memory)
        k = _split_heads(mk @ params["wk"]["w"].to(c.dtype), nkv, hd)
        v = _split_heads(mv @ params["wv"]["w"].to(c.dtype), nkv, hd)
        return k, v

    def _query(self, params, x):
        """Cross-attention queries: no qk-norm, no RoPE."""
        nh, _, hd = self.dims
        return _split_heads(x @ params["wq"]["w"].to(self.cfg.dtype), nh, hd)

    # -- full-sequence (train / prefill) ------------------------------------------
    def apply(self, params, x, *, window=None, positions=None, memory=None,
              return_kv: bool = False):
        """x: (B, T, d_model) -> (B, T, d_model) [, {"k", "v"}].  ``memory``
        (B, S_enc, d): cross-attention, k and v from the memory."""
        c = self.cfg
        nh, nkv, hd = self.dims
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device)[None, :]
        if memory is None:
            q, k, v = self._qkv(params, x, positions)
        else:
            q = self._query(params, x)
            k, v = self._memory_kv(params, memory)
        q, k, v = shard_attn_qkv(q, k, v)
        if self.use_flash and memory is None and q.shape[1] == k.shape[1] and \
                isinstance(window, (int, type(None))):
            from repro_torch.kernels.flash_attention import ops as flash_ops
            y = _attend_on_shards(
                lambda q_, k_, v_: flash_ops.flash_attention(
                    q_, k_, v_, causal=self.causal, window=window or 0), q, k, v)
        else:
            y = _attend_on_shards(
                lambda q_, k_, v_, pos_: self._sdpa(q_, k_, v_, window=window,
                                                    causal=self.causal and memory is None,
                                                    q_positions=pos_),
                q, k, v, positions=positions)
        y = _rows_to_features(pin_grad(y.reshape(B, T, nh * hd)))
        y = y @ params["wo"]["w"].to(c.dtype)
        y = shard(y, *batch_spec(None, None))
        if return_kv:
            return y, {"k": k, "v": v}
        return y

    def _sdpa(self, q, k, v, *, window, causal, q_positions=None, k_positions=None):
        # head counts from the tensors: on a mesh these are a rank's shards
        (B, T, nh, hd), nkv = q.shape, k.shape[2]
        group = nh // max(nkv, 1)
        S = k.shape[1]
        qh = q.reshape(B, T, nkv, group, hd)
        logits = torch.einsum("btkgd,bskd->bkgts", qh, k).float()
        logits = logits * (1.0 / math.sqrt(hd))
        qpos = torch.arange(T, device=q.device) if q_positions is None else q_positions[0]
        kpos = torch.arange(S, device=q.device) if k_positions is None else k_positions
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        y = torch.einsum("bkgts,bskd->btkgd", probs, v)
        return y.reshape(B, T, nh, hd)

    # -- single-token decode against a KV cache -----------------------------------
    def decode(self, params, x, cache, index, *, window=None, memory=None,
               donate: bool = False):
        """x: (B, 1, d); cache: dict(k=(B,S,nkv,hd), v=...); index: the
        position being written — a scalar int (lockstep batch) or a (B,)
        vector of per-row positions (continuous batching).  Returns
        (y, new_cache); the cache given is not modified unless ``donate``.
        ``memory`` (B, S_enc, d): cross-attention over the whole memory, the
        cache returned as given."""
        c = self.cfg
        nh, nkv, hd = self.dims
        B = x.shape[0]
        if memory is not None:
            y = self.decode_memory(params, x, self.build_memory_cache(params, memory))
            return shard(y, *batch_spec(None, None)), cache
        idx = decode_positions(index, B, x.device)
        q, k1, v1 = self._qkv(params, x, idx[:, None])
        if not donate:
            cache = {key: t.clone() for key, t in cache.items()}
        k, v = cache["k"], cache["v"]
        kpos = torch.arange(k.shape[1], device=x.device)
        if torch.as_tensor(index).dim() == 0 and not is_sharded(k):
            # lockstep: one slice written, shared (S,) mask
            i = int(index)
            k[:, i:i + 1] = k1.to(k.dtype)
            v[:, i:i + 1] = v1.to(v.dtype)
            valid = kpos <= i
            if window is not None:
                valid &= kpos > i - window
        else:
            # per-row scatter: row b writes its own position idx[b]
            _write_rows(cache, idx, k1, v1, idx)
            valid = kpos[None, :] <= idx[:, None]
            if window is not None:
                valid &= kpos[None, :] > idx[:, None] - window
        y = self._decode_attend(q, k, v, valid)
        y = y.reshape(B, 1, nh * hd) @ params["wo"]["w"].to(c.dtype)
        return shard(y, *batch_spec(None, None)), cache

    def decode_ring(self, params, x, cache, index, *, donate: bool = False):
        """Sliding-window decode on a ring-buffer cache of width W: the
        cache read is O(W), not O(S).  cache: {k,v: (B,W,nkv,hd), pos:
        (B,W) int32, -1 = empty}; ring slot ``s`` holds position ``p ≡ s
        (mod W)``.  ``index`` may be scalar (lockstep) or (B,) per-row
        positions (continuous batching)."""
        c = self.cfg
        nh, nkv, hd = self.dims
        B = x.shape[0]
        W = cache["k"].shape[1]
        idx = decode_positions(index, B, x.device)
        q, k1, v1 = self._qkv(params, x, idx[:, None])
        if not donate:
            cache = {key: t.clone() for key, t in cache.items()}
        _write_rows(cache, torch.remainder(idx, W), k1, v1, idx)
        valid = (cache["pos"] >= 0) & (cache["pos"] <= idx[:, None])      # (B, W)
        y = self._decode_attend(q, cache["k"], cache["v"], valid)
        y = y.reshape(B, 1, nh * hd) @ params["wo"]["w"].to(c.dtype)
        return shard(y, *batch_spec(None, None)), cache

    def build_memory_cache(self, params, memory):
        """Cross-attention k/v of the encoder's output (B, S_enc, d), once."""
        k, v = self._memory_kv(params, memory)
        return {"k": k, "v": v}

    def decode_memory(self, params, x, mem_cache):
        """Single-token cross-attention against a prebuilt memory cache."""
        c = self.cfg
        nh, _, hd = self.dims
        B, S = x.shape[0], mem_cache["k"].shape[1]
        y = self._decode_attend(self._query(params, x), mem_cache["k"], mem_cache["v"],
                                torch.ones(S, dtype=torch.bool, device=x.device))
        y = y.reshape(B, 1, nh * hd) @ params["wo"]["w"].to(c.dtype)
        return shard(y, *batch_spec(None, None))

    def _decode_attend(self, q, k, v, valid):
        # valid: (S,) shared mask, or (B, S) per-row (continuous batching)
        return _attend_on_shards(self._attend1, q, k, v, valid=valid)

    @staticmethod
    def _attend1(q, k, v, valid):
        (B, _, nh, hd), nkv = q.shape, k.shape[2]
        group = nh // max(nkv, 1)
        qh = q.reshape(B, nkv, group, hd)
        logits = torch.einsum("bkgd,bskd->bkgs", qh, k.to(q.dtype)).float()
        logits = logits * (1.0 / math.sqrt(hd))
        mask = valid[None, None, None] if valid.dim() == 1 else valid[:, None, None, :]
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        y = torch.einsum("bkgs,bskd->bkgd", probs, v.to(q.dtype))
        return y.reshape(B, 1, nh, hd)

    def init_cache(self, batch: int, seq: int, dtype=None, *, ring: bool = False,
                   device=None):
        c = self.cfg
        _, nkv, hd = self.dims
        dt = dtype or c.dtype
        cache = {"k": torch.zeros((batch, seq, nkv, hd), dtype=dt, device=device),
                 "v": torch.zeros((batch, seq, nkv, hd), dtype=dt, device=device)}
        if ring:
            cache["pos"] = torch.full((batch, seq), -1, dtype=torch.int32, device=device)
        return cache


def _split_heads(y, heads: int, hd: int):
    """A projection (..., heads * hd) -> (..., heads, hd).  On a mesh, a
    last dim sharded over ranks that do not divide ``heads`` is gathered
    first: DTensor views a sharded dim only into an outer dim its ranks
    divide (gemma3-4b's 8 heads on a 16-way "model" axis)."""
    if is_sharded(y):
        from torch.distributed.tensor import Shard
        nd = y.ndim
        ranks = math.prod(y.device_mesh.shape[i] for i, p in enumerate(y.placements)
                          if isinstance(p, Shard) and p.dim % nd == nd - 1)
        if heads % ranks:
            y = whole_dims(y, nd - 1)
    return y.reshape(*y.shape[:-1], heads, hd)


def _attend_on_shards(kernel, q, k, v, *, positions=None, valid=None):
    """``kernel(q, k, v[, valid][, positions])`` (B, T, heads, head_dim) ->
    like q: flash or the plain attention, or a decode (``valid``, its mask:
    (S,) shared or (B, S) per row).  Under a mesh it runs on the local
    shards: head_dim enters whole (the kernel contracts it), and so do the
    keys' sequence and, unless split by rows, the queries'.  Each mesh dim
    of more than one rank splits the work, in this order: q's heads stay
    sharded where its ranks divide them (k and v then sharded alike, their
    heads repeated to q's count where the ranks do not divide the kv
    heads, so each rank keeps whole GQA groups); else the batch is sharded
    where it divides (per-row masks follow the batch); else, where the
    kernel takes ``positions`` (the queries' global positions, (1 or B,
    T)), the query rows are: each rank takes its uneven ``Shard(1)`` cut
    of q and of ``positions`` and the keys and values whole, so every
    row's softmax is whole on one rank and the ranks' k and v gradients
    are partial sums (``_kv_grad``); else, in a decode, the cache stays
    where ``launch.steps.cache_specs`` put it: split by its keys or by
    head_dim (``_decode_on_shards``).  The flash kernel takes no
    positions, so on such a dim it runs whole on every rank: the kernel
    has no query offset, and the reference's Pallas call has no
    partitioning rule either (GSPMD runs it whole on each device).
    DTensor's own propagation is not asked to flatten the batch and head
    dims sharded on two mesh axes, which some versions refuse.  Plain
    tensors go straight in."""
    pos = () if positions is None else (positions,)
    mask = () if valid is None else (valid,)
    if not is_sharded(q):
        return kernel(q, k, v, *mask, *pos)
    from torch.distributed.tensor import Replicate, Shard
    q = whole_dims(q, 1, 3)
    mesh = q.device_mesh
    (B, T, nh, hd), nkv = q.shape, k.shape[2]
    kpl = tuple(k.placements) if is_sharded(k) else (Replicate(),) * mesh.ndim
    roles, on_heads, on_batch = [], 1, 1
    for n, p, kp in zip(mesh.shape, q.placements, kpl):
        if p == Shard(2) and nh % (on_heads * n) == 0:
            roles.append("heads")
            on_heads *= n
        elif p == Shard(0) or (n > 1 and B % (on_batch * n) == 0):
            roles.append("batch")
            on_batch *= n
        elif n > 1 and pos:
            roles.append("rows")
        elif n > 1 and mask and kp in (Shard(1), Shard(3)):
            roles.append("keys" if kp == Shard(1) else "head_dim")
        else:
            roles.append(None)
    if "keys" in roles or "head_dim" in roles:
        return _decode_on_shards(q, k, v, valid, roles, on_heads)
    want = _by_role(roles, heads=Shard(2), batch=Shard(0), rows=Shard(1))
    by_row = _by_role(roles, batch=Shard(0))
    kv = _by_role(roles, heads=Shard(2), batch=Shard(0))
    if nkv % on_heads:
        k, v = (_repeat_heads(_put(t, mesh, by_row), nh) for t in (k, v))
    args = [_put(q, mesh, want), _put(k, mesh, kv), _put(v, mesh, kv)]
    if mask:
        args.append(_put(valid, mesh, by_row if valid.dim() == 2 else _by_role(roles)))
    if pos:
        args.append(_put(positions, mesh, _by_role(roles, rows=Shard(1))))
    if "rows" not in roles:
        return local_kernel(kernel, want, *args)
    grads = (None, _kv_grad(want, kv), _kv_grad(want, kv)) + (None,) * (len(args) - 3)
    # contiguous: DTensor reshapes a row-split shard with ``view``, which
    # the plain route's permuted einsum output may refuse
    return local_kernel(lambda *a: kernel(*a).contiguous(), want, *args,
                        in_grad_placements=grads, out_shape=(B, T, nh, hd))


# decode attention calls split over a mesh dim by the cache's keys or by
# head_dim (``_decode_on_shards``), by kind
DECODE_SPLITS = {"keys": 0, "head_dim": 0}


def _decode_on_shards(q, k, v, valid, roles, on_heads):
    """Decode attention (one query a row) on a mesh where a dim of more
    than one rank splits neither q's heads nor the batch and the cache is
    sharded there (``roles``: "keys" where k is sharded by its sequence,
    the batch-1 long decode's context parallelism; "head_dim" where by
    head_dim, the reference's ``shard_attn_qkv`` fallback).  Each rank
    contracts its slice of head_dim against its slice of the keys; the
    partial logits are summed over the head_dim dims; each rank's softmax
    part over its keys, masked by its slice of ``valid``, is merged over
    the keys dims (``_merge_keys``: one max, one sum); ``probs @ v`` gives
    the rank's slice of y, gathered at the end (y is batch x heads x
    head_dim, never the cache).  Heads and batch dims split as in
    ``_attend_on_shards``; no dim gathers the cache."""
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    _, _, nh, hd = q.shape
    if k.shape[2] % on_heads:
        keep = _by_role(roles, batch=Shard(0), keys=Shard(1), head_dim=Shard(3))
        k, v = (_repeat_heads(_put(t, mesh, keep), nh) for t in (k, v))
    qy = _by_role(roles, heads=Shard(2), batch=Shard(0), head_dim=Shard(3))
    kv = _by_role(roles, heads=Shard(2), batch=Shard(0), keys=Shard(1), head_dim=Shard(3))
    mask = (_by_role(roles, batch=Shard(0), keys=Shard(1)) if valid.dim() == 2 else
            _by_role(roles, keys=Shard(0)))
    dims = {role: [i for i, r in enumerate(roles) if r == role] for role in DECODE_SPLITS}
    for role, on in dims.items():
        DECODE_SPLITS[role] += bool(on)

    def reduce_over(role):
        return lambda t, op: _all_reduce(t, op, mesh, dims[role])

    def kernel(q_, k_, v_, valid_):
        logits = reduce_over("head_dim")(_decode_logits(q_, k_), "sum")
        top, part = _decode_part(logits, v_, valid_, hd)
        return _decode_out(_merge_keys(top, part, reduce_over("keys")), q_)

    y = local_kernel(kernel, qy, _put(q, mesh, qy), _put(k, mesh, kv), _put(v, mesh, kv),
                     _put(valid, mesh, mask))
    return whole_dims(y, 3)


def _decode_logits(q, k):
    """q (B, 1, heads, d) against k (B, S, kv heads, d): the float32 logits
    (B, kv heads, group, S), unscaled; over a slice of head_dim, that
    slice's share of them."""
    (B, _, nh, d), nkv = q.shape, k.shape[2]
    return torch.einsum("bkgd,bskd->bkgs", q.reshape(B, nkv, nh // nkv, d).float(), k.float())


def _decode_part(logits, v, valid, hd):
    """One slice of the keys: its logits (summed over head_dim) scaled by
    1/sqrt(hd) and masked by its ``valid`` ((S,) or (B, S)); their max
    ``top`` (B, kv heads, group, 1), and ``part``: the float32
    ``exp(logits - top) @ v``, unnormalised, beside its row sums (B, kv
    heads, group, d + 1).  A slice with every key masked has top NEG_INF
    and no NaN: the merge weighs it by zero beside a slice with a key."""
    logits = torch.where(valid[None, None, None] if valid.dim() == 1 else
                         valid[:, None, None, :], logits * (1.0 / math.sqrt(hd)), NEG_INF)
    top = (logits.amax(-1, keepdim=True) if logits.shape[-1] else
           logits.new_full(logits.shape[:-1] + (1,), NEG_INF))
    p = torch.exp(logits - top)
    return top, torch.cat([torch.einsum("bkgs,bskd->bkgd", p, v.float()),
                           p.sum(-1, keepdim=True)], -1)


def _merge_keys(top, part, reduce):
    """The key slices' parts merged: each rescaled to the slices' max and
    summed.  ``reduce(t, "max" | "sum")`` reduces over the slices: an
    all-reduce over the mesh dims that split the keys (the identity where
    none does), or over a leading dim of slices stacked in one tensor."""
    best = reduce(top, "max")
    return reduce(part * torch.exp(top - best), "sum")


def _decode_out(part, q):
    """The merged part normalised: y like q (B, 1, heads, d)."""
    return (part[..., :-1] / part[..., -1:]).to(q.dtype).reshape(q.shape)


def _all_reduce(t, op, mesh, dims):
    """``t`` all-reduced by ``op`` ("sum" or "max") over the mesh dims
    ``dims`` in turn (a functional collective each)."""
    from torch.distributed import _functional_collectives as funcol
    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


def _by_role(roles, **placement):
    """One placement a mesh dim: the one given for its role, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate
    return tuple(placement.get(r, Replicate()) if r else Replicate() for r in roles)


def _put(t, mesh, placements):
    if is_sharded(t):
        return t.redistribute(mesh, placements)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _repeat_heads(t, nh):
    """k or v (B, S, kv heads, d) with each kv head repeated to its group
    of q's ``nh`` heads."""
    B, S, nkv, d = t.shape
    return t.unsqueeze(3).expand(B, S, nkv, nh // nkv, d).reshape(B, S, nh, d)


def _rows_to_features(y):
    """A query-row split attention's output (B, T, heads * head_dim) with
    each row-split mesh dim moved to the features, the layout of wo's rows
    (wo is row-parallel): the product and wo's gradient are then each
    rank's share.  From row-split y DTensor would gather wo and take its
    whole gradient on every rank.  Other layouts are returned as they
    are."""
    if not is_sharded(y):
        return y
    from torch.distributed.tensor import Shard
    want = tuple(Shard(2) if p == Shard(1) else p for p in y.placements)
    return y if want == tuple(y.placements) else pin_grad(y.redistribute(y.device_mesh, want))


def _kv_grad(want, kv):
    """The placements of k's and v's gradients out of a query-row split
    attention: on a dim whose ranks split the rows, each rank's gradient
    is its own rows' share, a partial sum over the ranks."""
    from torch.distributed.tensor import Partial, Shard
    return tuple(Partial() if w == Shard(1) else p for w, p in zip(want, kv))


def _write_rows(cache, slot, k1, v1, idx):
    """Row b's new k/v into sequence slot ``slot[b]`` of the cache, in place
    (and, in a ring cache, position ``idx[b]`` into its ``pos``)."""
    if is_sharded(cache["k"]):
        return _write_rows_on_shards(cache, slot, k1, v1, idx)
    rows = torch.arange(k1.shape[0], device=k1.device)
    k, v = cache["k"], cache["v"]
    k.index_put_((rows, slot), k1[:, 0].to(k.dtype))
    v.index_put_((rows, slot), v1[:, 0].to(v.dtype))
    if "pos" in cache:
        cache["pos"].index_put_((rows, slot), idx.to(cache["pos"].dtype))


def _write_rows_on_shards(cache, slot, k1, v1, idx):
    """``_write_rows`` into a cache placed on a mesh, each rank writing its
    own shard in place (an in-place write cannot move the cache's
    placement).  A leaf's rows follow its batch sharding, the new values
    its other shardings.  Where the sequence is sharded (the batch-1
    context parallel cache) a rank writes the rows whose slot falls in its
    range, as a masked rewrite of its shard."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    vals = {"k": k1[:, 0], "v": v1[:, 0]}
    if "pos" in cache:
        vals["pos"] = idx
    for key, val in vals.items():
        dst = cache[key]
        mesh, pl = dst.device_mesh, dst.placements
        B, S = dst.shape[0], dst.shape[1]

        def local(t, placements):
            if is_sharded(t):
                return t.redistribute(mesh, placements).to_local()
            return distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()

        # the written row: the leaf's placements with its sequence dim dropped
        row_pl = tuple(Replicate() if p == Shard(1) else
                       Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
                       for p in pl)
        val = local(val, row_pl).to(dst.dtype)
        slot_l = local(slot, tuple(p if p == Shard(0) else Replicate() for p in pl))
        out = dst.to_local()
        if any(p == Shard(1) for p in pl):
            seq = local(torch.arange(S, device=slot_l.device),
                        tuple(Shard(0) if p == Shard(1) else Replicate() for p in pl))
            hit = seq[None, :] == slot_l[:, None]                        # (B_l, S_l)
            hit = hit.reshape(tuple(hit.shape) + (1,) * (out.dim() - 2))
            out.copy_(torch.where(hit, val[:, None], out))
        else:
            rows = torch.arange(out.shape[0], device=out.device)
            out.index_put_((rows, slot_l), val)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SwiGLU(nn.Module):
    cfg: ArchConfig
    d_ff: int = 0

    def init(self, gen):
        c = self.cfg
        ff = self.d_ff or c.d_ff
        return {
            "w_gate": nn.Dense(c.d_model, ff, use_bias=False, dtype=c.param_dtype).init(gen),
            "w_up": nn.Dense(c.d_model, ff, use_bias=False, dtype=c.param_dtype).init(gen),
            "w_down": nn.Dense(ff, c.d_model, use_bias=False, dtype=c.param_dtype).init(gen),
        }

    def apply(self, params, x):
        c = self.cfg
        g = x @ params["w_gate"]["w"].to(c.dtype)
        u = x @ params["w_up"]["w"].to(c.dtype)
        h = F.silu(g) * u
        h = shard(h, *batch_spec(None, "model"))
        y = h @ params["w_down"]["w"].to(c.dtype)
        return shard(y, *batch_spec(None, None))
