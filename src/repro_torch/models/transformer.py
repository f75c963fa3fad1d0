"""Backbone model (a port of ``repro.models.transformer``): one definition
covering every family of the zoo.

Families
  dense / vlm : decoder blocks (uniform window, or grouped local:global
                à la gemma3); vlm is the plain stack on one early-fusion
                token stream (chameleon)
  moe         : decoder blocks with an MoE FFN, whose router aux loss is
                summed over the layers
  ssm         : Mamba2 blocks (attention-free)
  hybrid      : zamba2-style — Mamba2 stacks with a *shared* decoder block
                applied every ``hybrid_period`` blocks
  audio       : whisper-style enc-dec; the conv/mel frontend is a stub, so
                the encoder consumes precomputed frame embeddings

Entry points:
  init(gen) -> params                   # drawn on the generator's device
  apply(params, tokens, ...)            # full-sequence forward
  prefill(params, tokens, ...)          # forward + decode-cache build
  encode(params, frames)                # audio: the encoder's memory
  build_cross_cache(params, memory)     # audio: every layer's cross k/v
  init_cache(batch, seq)                # zeroed decode cache
  decode(params, token, cache, index)   # ONE-token serve step

Parameters keep the reference's pytree: stacked layer params with their
leading ``(L,)`` or ``(G, r)`` dims, so the conversion from the reference
is leaf by leaf.  The reference's ``lax.scan`` over a stack is a Python
loop over its leading dim here.  ``ring_cache=True`` gives the
sliding-window layers O(W) ring-buffer caches.  The reference's ``remat``
(``jax.checkpoint`` over the scan bodies) has no counterpart:
``torch.utils.checkpoint`` does not compose with the ``torch.func.vmap``
of the agents' gradients, and it changes no number.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import nn, resolve_device
from repro_torch.dist.sharding import batch_spec, shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Attention, SwiGLU, make_norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2Block
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

def _pad_attn_cache(cache, extra: int):
    """Right-pad the sequence axis (-3) of attention k/v buffers; cross-attn
    memory caches and SSM/conv state are untouched."""

    def walk(tree, under_cross=False):
        if isinstance(tree, dict):
            return {k: (walk(v, under_cross or k == "cross") if isinstance(v, dict)
                        else (_pad_leaf(k, v) if not under_cross else v))
                    for k, v in tree.items()}
        return tree

    def _pad_leaf(key, leaf):
        if key in ("k", "v") and leaf.dim() >= 3:
            return F.pad(leaf, (0, 0, 0, 0, 0, extra))
        return leaf

    return walk(cache)


def stack_init(module: nn.Module, gen, n: int):
    """n independent inits stacked along a leading layer axis.  The stack
    is allocated once and filled layer by layer, so a full-width init holds
    the stack and one layer, not two stacks."""
    n = max(n, 1)
    first = module.init(gen)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    for i in range(n):
        layer = first if i == 0 else module.init(gen)
        tree_map(lambda o, x: o[i].copy_(x), out, layer)
    return out


def stack_init2(module: nn.Module, gen, n_outer: int, n_inner: int):
    flat = stack_init(module, gen, n_outer * n_inner)
    return tree_map(lambda x: x.reshape((n_outer, n_inner) + tuple(x.shape[1:])), flat)


def _layer(stacked, *idx):
    """One layer's params (or cache) out of a stack."""
    return tree_map(lambda x: x[idx], stacked)


def _layers(stacked, n: int) -> list:
    """The ``n`` per-layer trees of a stack (leading dim ``n``), unbound
    once.  Under a gradient this matters: the backward of ``n`` indexings
    allocates a zeroed stack per layer for each leaf, the backward of one
    unbind stacks the layers' gradients once, after the last of them."""
    leaves, treedef = tree_flatten(stacked)
    cols = [torch.unbind(x, 0) for x in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


def _stack(trees, lead=None):
    """Per-layer trees -> one tree stacked along a leading dim, reshaped to
    the leading dims ``lead`` (e.g. (groups, per)) when given."""
    out = tree_map(lambda *xs: torch.stack(xs), *trees)
    if lead is None:
        return out
    return tree_map(lambda x: x.reshape(tuple(lead) + tuple(x.shape[1:])), out)


# ---------------------------------------------------------------------------
# Decoder block: attention + (SwiGLU | MoE), optional cross-attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecoderBlock(nn.Module):
    cfg: ArchConfig
    use_moe: bool = False
    cross: bool = False
    causal: bool = True
    use_flash: bool = False

    @property
    def attn(self):
        return Attention(self.cfg, causal=self.causal, use_flash=self.use_flash)

    @property
    def mlp(self):
        return MoE(self.cfg) if self.use_moe else SwiGLU(self.cfg)

    @property
    def xattn(self):
        """The cross-attention over the encoder's memory: never the flash
        kernel, as in the reference."""
        return Attention(self.cfg, causal=False)

    def init(self, gen):
        c = self.cfg
        p = {"ln1": make_norm(c, c.d_model).init(gen),
             "attn": self.attn.init(gen),
             "ln2": make_norm(c, c.d_model).init(gen),
             "mlp": self.mlp.init(gen)}
        if self.cross:
            p["lnx"] = make_norm(c, c.d_model).init(gen)
            p["xattn"] = self.xattn.init(gen)
        return p

    def _norm(self):
        return make_norm(self.cfg, self.cfg.d_model)

    def apply(self, params, h, *, window=None, memory=None, return_kv=False):
        """-> (h, aux[, kv]); aux is the MoE router's loss, else a float32 0.
        ``memory``: the encoder's output, which a cross block attends to."""
        norm = self._norm()
        a = self.attn.apply(params["attn"], norm.apply(params["ln1"], h),
                            window=window, return_kv=return_kv)
        if return_kv:
            a, kv = a
        h = h + a
        if self.cross:
            h = h + self.xattn.apply(params["xattn"], norm.apply(params["lnx"], h),
                                     memory=memory)
        m = self.mlp.apply(params["mlp"], norm.apply(params["ln2"], h))
        if self.use_moe:
            m, aux = m
        else:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        h = h + m
        if return_kv:
            return h, aux, kv
        return h, aux

    def decode(self, params, h, cache, index, *, window=None, ring=False, donate=False,
               mem_cache=None):
        norm = self._norm()
        x = norm.apply(params["ln1"], h)
        if ring:
            a, new_cache = self.attn.decode_ring(params["attn"], x, cache, index,
                                                 donate=donate)
        else:
            a, new_cache = self.attn.decode(params["attn"], x, cache, index,
                                            window=window, donate=donate)
        h = h + a
        if self.cross and mem_cache is not None:
            h = h + self.xattn.decode_memory(params["xattn"],
                                             norm.apply(params["lnx"], h), mem_cache)
        m = self.mlp.apply(params["mlp"], norm.apply(params["ln2"], h))
        if self.use_moe:
            m, _ = m
        return h + m, new_cache


@dataclasses.dataclass(frozen=True)
class MambaLayer(nn.Module):
    """Pre-norm residual wrapper around Mamba2Block."""

    cfg: ArchConfig
    use_kernel: bool = False

    @property
    def inner(self):
        return Mamba2Block(self.cfg, use_kernel=self.use_kernel)

    def init(self, gen):
        return {"ln": make_norm(self.cfg, self.cfg.d_model).init(gen),
                "mixer": self.inner.init(gen)}

    def apply(self, params, h, *, return_state=False):
        norm = make_norm(self.cfg, self.cfg.d_model)
        y = self.inner.apply(params["mixer"], norm.apply(params["ln"], h),
                             return_state=return_state)
        if return_state:
            y, state = y
            return h + y, state
        return h + y

    def decode(self, params, h, cache, *, donate=False):
        norm = make_norm(self.cfg, self.cfg.d_model)
        y, new_cache = self.inner.decode(params["mixer"], norm.apply(params["ln"], h),
                                         cache, donate=donate)
        return h + y, new_cache


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Backbone(nn.Module):
    cfg: ArchConfig
    use_flash: bool = False
    use_ssd_kernel: bool = False
    ring_cache: bool = False  # sliding-window layers use O(W) ring buffers

    # ---- structure helpers ----
    @property
    def grouped(self) -> bool:
        return self.cfg.local_global_ratio > 0

    @property
    def n_groups(self) -> int:
        c = self.cfg
        if c.family == "hybrid":
            return c.num_layers // c.hybrid_period
        return c.num_layers // (c.local_global_ratio + 1) if self.grouped else 0

    @property
    def n_tail(self) -> int:
        c = self.cfg
        if c.family == "hybrid":
            return c.num_layers % c.hybrid_period
        return c.num_layers % (c.local_global_ratio + 1) if self.grouped else 0

    def _block(self, causal=True, cross=False):
        return DecoderBlock(self.cfg, use_moe=self.cfg.num_experts > 0, cross=cross,
                            causal=causal, use_flash=self.use_flash)

    def _mamba(self):
        return MambaLayer(self.cfg, use_kernel=self.use_ssd_kernel)

    # ---- init ----
    def init(self, gen):
        c = self.cfg
        p: dict[str, Any] = {
            "embed": nn.Embedding(c.padded_vocab, c.d_model, dtype=c.param_dtype).init(gen),
            "final_norm": make_norm(c, c.d_model).init(gen),
        }
        if not c.tie_embeddings:
            p["lm_head"] = nn.Dense(c.d_model, c.padded_vocab, use_bias=False,
                                    dtype=c.param_dtype).init(gen)
        if c.family == "ssm":
            p["blocks"] = stack_init(self._mamba(), gen, c.num_layers)
        elif c.family == "hybrid":
            p["shared_attn"] = self._block().init(gen)
            p["mamba"] = stack_init2(self._mamba(), gen, self.n_groups, c.hybrid_period - 1)
            if self.n_tail:
                p["mamba_tail"] = stack_init(self._mamba(), gen, self.n_tail)
        elif c.family == "audio":
            p["enc_blocks"] = stack_init(self._block(causal=False), gen, c.encoder_layers)
            p["enc_norm"] = make_norm(c, c.d_model).init(gen)
            p["blocks"] = stack_init(self._block(cross=True), gen, c.num_layers)
        elif self.grouped:
            p["local"] = stack_init2(self._block(), gen, self.n_groups, c.local_global_ratio)
            p["global"] = stack_init(self._block(), gen, self.n_groups)
            if self.n_tail:
                p["tail"] = stack_init(self._block(), gen, self.n_tail)
        else:
            p["blocks"] = stack_init(self._block(), gen, c.num_layers)
        return p

    # ---- embedding / head ----
    def _embed(self, params, tokens):
        c = self.cfg
        h = nn.Embedding(c.padded_vocab, c.d_model).apply(params["embed"], tokens)
        return shard(h.to(c.dtype), *batch_spec(None, None))

    def _head(self, params, h, *, logits_mode: str = "full"):
        c = self.cfg
        h = make_norm(c, c.d_model).apply(params["final_norm"], h)
        if logits_mode == "none":
            return h, None
        hh = h[:, -1:] if logits_mode == "last" else h
        return h, self.project_logits(params, hh)

    def project_logits(self, params, h):
        """Head matmul on already-final-normed hidden states (B, T, d) ->
        (B, T, padded_vocab) float32."""
        c = self.cfg
        if c.tie_embeddings:
            logits = h @ params["embed"]["table"].T.to(c.dtype)
        else:
            logits = h @ params["lm_head"]["w"].to(c.dtype)
        return shard(logits.float(), *batch_spec(None, "model"))

    # ---- full-sequence forward ----
    def apply(self, params, tokens, *, encoder_frames=None, collect_cache: bool = False,
              logits_mode: str = "full"):
        """Returns dict(hidden, logits, aux[, cache][, memory]).
        ``logits_mode``: "full" (training), "last" (prefill — only the
        next-token logits), or "none".  The audio family takes
        ``encoder_frames`` (B, S_enc, d_model); with ``collect_cache`` its
        encoder output comes back as ``memory``."""
        c = self.cfg
        h = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        caches: dict[str, Any] = {}
        memory = self.encode(params, encoder_frames) if c.family == "audio" else None
        if c.family == "ssm":
            layer = self._mamba()
            states = []
            for bp in _layers(params["blocks"], c.num_layers):
                if collect_cache:
                    h, st = layer.apply(bp, h, return_state=True)
                    states.append(st)
                else:
                    h = layer.apply(bp, h)
            if collect_cache:
                caches["blocks"] = _stack(states)
        elif c.family == "hybrid":
            h, aux, caches = self._hybrid_forward(params, h, aux, collect_cache)
        elif c.family == "audio":
            block = self._block(cross=True)
            kvs, mem_kvs = [], []
            for bp in _layers(params["blocks"], c.num_layers):
                out = block.apply(bp, h, memory=memory, return_kv=collect_cache)
                h, a = out[:2]
                aux = aux + a
                if collect_cache:
                    kvs.append(out[2])
                    mem_kvs.append(block.attn.build_memory_cache(bp["xattn"], memory))
            if collect_cache:
                caches["self"], caches["cross"] = _stack(kvs), _stack(mem_kvs)
        elif self.grouped:
            h, aux, caches = self._grouped_forward(params, h, aux, collect_cache)
        else:
            block = self._block()
            window = c.sliding_window if c.sliding_window > 0 else None
            kvs = []
            for bp in _layers(params["blocks"], c.num_layers):
                out = block.apply(bp, h, window=window, return_kv=collect_cache)
                h, a = out[:2]
                aux = aux + a
                if collect_cache:
                    kvs.append(out[2])
            if collect_cache:
                caches["blocks"] = _stack(kvs)

        hidden, logits = self._head(params, h, logits_mode=logits_mode)
        out = {"hidden": hidden, "logits": logits, "aux": aux}
        if collect_cache:
            out["cache"] = caches
            if memory is not None:
                out["memory"] = memory
        return out

    def _grouped_forward(self, params, h, aux, collect_cache):
        """gemma3-style [ratio local + 1 global] groups + local tail; the
        layers' aux losses summed onto ``aux``."""
        c = self.cfg
        block = self._block()
        W = c.sliding_window
        gw = W if c.global_uses_window else None
        total = [aux]

        def run(bp, hh, window, kvs):
            out = block.apply(bp, hh, window=window, return_kv=collect_cache)
            total[0] = total[0] + out[1]
            if collect_cache:
                kvs.append(out[2])
            return out[0]

        local, glob, tail = [], [], []
        for lp, gp in zip(_layers(params["local"], self.n_groups),
                          _layers(params["global"], self.n_groups)):
            for bp in _layers(lp, c.local_global_ratio):
                h = run(bp, h, W, local)
            h = run(gp, h, gw, glob)
        for bp in _layers(params["tail"], self.n_tail) if self.n_tail else ():
            h = run(bp, h, W, tail)
        caches = {}
        if collect_cache:
            caches["local"] = _stack(local, (self.n_groups, c.local_global_ratio))
            caches["global"] = _stack(glob)
            if self.n_tail:
                caches["tail"] = _stack(tail)
        return h, total[0], caches

    def _hybrid_forward(self, params, h, aux, collect_cache):
        """zamba2-style: every group is the one shared decoder block (one
        parameter set, applied at every group) and then ``hybrid_period -
        1`` Mamba2 layers; the tail is Mamba2 layers."""
        c = self.cfg
        block, mamba = self._block(), self._mamba()
        per = c.hybrid_period - 1
        kvs, states, tail = [], [], []

        def run_mamba(bp, hh, out):
            if collect_cache:
                hh, st = mamba.apply(bp, hh, return_state=True)
                out.append(st)
                return hh
            return mamba.apply(bp, hh)

        for mp in _layers(params["mamba"], self.n_groups):
            out = block.apply(params["shared_attn"], h, window=None, return_kv=collect_cache)
            h, a = out[:2]
            aux = aux + a
            if collect_cache:
                kvs.append(out[2])
            for bp in _layers(mp, per):
                h = run_mamba(bp, h, states)
        for bp in _layers(params["mamba_tail"], self.n_tail) if self.n_tail else ():
            h = run_mamba(bp, h, tail)
        caches = {}
        if collect_cache:
            caches["attn"] = _stack(kvs)
            caches["mamba"] = _stack(states, (self.n_groups, per))
            if self.n_tail:
                caches["tail"] = _stack(tail)
        return h, aux, caches

    # ---- encoder (audio) ----
    def encode(self, params, frames):
        """frames: (B, S_enc, d_model), the stubbed frontend's embeddings ->
        the encoder's memory (B, S_enc, d_model): non-causal blocks, then
        ``enc_norm``."""
        c = self.cfg
        if frames is None:
            raise ValueError(f"{c.name}: the audio family's forward needs encoder_frames")
        h = shard(frames.to(c.dtype), *batch_spec(None, None))
        block = self._block(causal=False)
        for bp in _layers(params["enc_blocks"], c.encoder_layers):
            h, _ = block.apply(bp, h, window=None)
        return make_norm(c, c.d_model).apply(params["enc_norm"], h)

    # ---- prefill ----
    def prefill(self, params, tokens, *, encoder_frames=None, max_seq: int = 0,
                logits_mode: str = "last"):
        """Full forward + decode-cache build.  ``max_seq > T`` right-pads the
        attention caches so ``decode`` can continue writing at index >= T
        (the cross-attention caches keep the encoder's length)."""
        out = self.apply(params, tokens, encoder_frames=encoder_frames, collect_cache=True,
                         logits_mode=logits_mode)
        T = tokens.shape[1]
        if max_seq and max_seq > T:
            out["cache"] = _pad_attn_cache(out["cache"], max_seq - T)
        return out

    # ---- cross-attention cache (audio) ----
    def build_cross_cache(self, params, memory):
        """Every decoder layer's cross-attention k/v of the encoder's output
        (B, S_enc, d): {"k", "v"} stacked over the layers, (L, B, S_enc, n_kv,
        head_dim), the layout of ``cache["cross"]`` in ``init_cache`` and
        ``prefill``."""
        c = self.cfg
        if c.family != "audio":
            raise ValueError("build_cross_cache: only the audio (enc-dec) family has "
                             f"cross-attention, got {c.family!r}")
        attn = self._block(cross=True).attn
        return _stack([attn.build_memory_cache(bp["xattn"], memory)
                       for bp in _layers(params["blocks"], c.num_layers)])

    # ---- decode cache ----
    @property
    def _ring(self) -> bool:
        return self.ring_cache and self.cfg.sliding_window > 0

    def init_cache(self, batch: int, seq: int, *, device="cuda"):
        """Zeroed decode cache on ``device`` (the card unless the caller asks
        for the CPU).  Under ``ring_cache`` the windowed layers (local and
        tail, and global ones when ``global_uses_window``) hold ring buffers
        of width ``min(sliding_window, seq)``."""
        c = self.cfg
        dev = resolve_device(device)

        def stacked(base, lead):
            return tree_map(lambda x: x.expand(lead + tuple(x.shape)).contiguous(), base)

        def mamba(lead):
            return stacked(Mamba2Block(c).init_cache(batch, device=dev), lead)

        if c.family == "ssm":
            return {"blocks": mamba((c.num_layers,))}
        W = min(c.sliding_window, seq) if c.sliding_window > 0 else seq
        ring = self._ring

        def kv(lead, windowed):
            r = ring and windowed
            return stacked(Attention(c).init_cache(batch, W if r else seq, ring=r,
                                                   device=dev), lead)

        if c.family == "hybrid":
            cache = {"attn": kv((self.n_groups,), False),
                     "mamba": mamba((self.n_groups, c.hybrid_period - 1))}
            if self.n_tail:
                cache["tail"] = mamba((self.n_tail,))
            return cache
        if c.family == "audio":
            shape = (c.num_layers, batch, c.encoder_seq, c.num_kv_heads, c.resolved_head_dim)
            return {"self": kv((c.num_layers,), False),
                    "cross": {k: torch.zeros(shape, dtype=c.dtype, device=dev)
                              for k in ("k", "v")}}
        if self.grouped:
            cache = {"local": kv((self.n_groups, c.local_global_ratio), True),
                     "global": kv((self.n_groups,), c.global_uses_window)}
            if self.n_tail:
                cache["tail"] = kv((self.n_tail,), True)
            return cache
        return {"blocks": kv((c.num_layers,), True)}

    # ---- one-token decode ----
    def decode(self, params, token, cache, index, *, donate: bool = False):
        """token: (B, 1) int; index: the position being generated — a scalar
        (lockstep batch) or a (B,) vector of per-row positions (continuous
        batching).  Returns (logits (B, 1, V), new_cache).  ``donate=True``
        writes every layer's cache in place and returns ``cache`` itself:
        the port's counterpart of the reference engine donating the cache
        to its compiled decode (no cache copy in a tick).  The audio
        family reads its cross-attention caches (``cache["cross"]``) and
        returns them as given."""
        c = self.cfg
        h = self._embed(params, token)
        if c.family == "ssm":
            mamba = self._mamba()
            new = []
            for i in range(c.num_layers):
                h, nc = mamba.decode(_layer(params["blocks"], i), h,
                                     _layer(cache["blocks"], i), donate=donate)
                new.append(nc)
            new_cache = cache if donate else {"blocks": _stack(new)}
        elif c.family == "hybrid":
            h, new_cache = self._hybrid_decode(params, h, cache, index, donate)
        elif c.family == "audio":
            block = self._block(cross=True)
            new = []
            for i in range(c.num_layers):
                h, nc = block.decode(_layer(params["blocks"], i), h, _layer(cache["self"], i),
                                     index, donate=donate,
                                     mem_cache=_layer(cache["cross"], i))
                new.append(nc)
            new_cache = cache if donate else {"self": _stack(new), "cross": cache["cross"]}
        elif self.grouped:
            h, new_cache = self._grouped_decode(params, h, cache, index, donate)
        else:
            block = self._block()
            window = c.sliding_window if c.sliding_window > 0 else None
            new = []
            for i in range(c.num_layers):
                h, nc = block.decode(_layer(params["blocks"], i), h,
                                     _layer(cache["blocks"], i), index, window=window,
                                     ring=self._ring, donate=donate)
                new.append(nc)
            new_cache = cache if donate else {"blocks": _stack(new)}
        _, logits = self._head(params, h)
        return logits, new_cache

    def _grouped_decode(self, params, h, cache, index, donate):
        c = self.cfg
        block = self._block()
        gw = c.sliding_window if c.global_uses_window else None
        ring, g_ring = self._ring, self._ring and c.global_uses_window
        local, glob, tail = [], [], []
        for g in range(self.n_groups):
            for r in range(c.local_global_ratio):
                h, nc = block.decode(_layer(params["local"], g, r), h,
                                     _layer(cache["local"], g, r), index,
                                     window=c.sliding_window, ring=ring, donate=donate)
                local.append(nc)
            h, nc = block.decode(_layer(params["global"], g), h,
                                 _layer(cache["global"], g), index, window=gw,
                                 ring=g_ring, donate=donate)
            glob.append(nc)
        for t in range(self.n_tail):
            h, nc = block.decode(_layer(params["tail"], t), h, _layer(cache["tail"], t),
                                 index, window=c.sliding_window, ring=ring, donate=donate)
            tail.append(nc)
        if donate:
            return h, cache
        new_cache = {"local": _stack(local, (self.n_groups, c.local_global_ratio)),
                     "global": _stack(glob)}
        if self.n_tail:
            new_cache["tail"] = _stack(tail)
        return h, new_cache

    def _hybrid_decode(self, params, h, cache, index, donate):
        c = self.cfg
        block, mamba = self._block(), self._mamba()
        per = c.hybrid_period - 1
        attn, states, tail = [], [], []
        for g in range(self.n_groups):
            h, nc = block.decode(params["shared_attn"], h, _layer(cache["attn"], g), index,
                                 donate=donate)
            attn.append(nc)
            for r in range(per):
                h, nc = mamba.decode(_layer(params["mamba"], g, r), h,
                                     _layer(cache["mamba"], g, r), donate=donate)
                states.append(nc)
        for t in range(self.n_tail):
            h, nc = mamba.decode(_layer(params["mamba_tail"], t), h, _layer(cache["tail"], t),
                                 donate=donate)
            tail.append(nc)
        if donate:
            return h, cache
        new_cache = {"attn": _stack(attn), "mamba": _stack(states, (self.n_groups, per))}
        if self.n_tail:
            new_cache["tail"] = _stack(tail)
        return h, new_cache
