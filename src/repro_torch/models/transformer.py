"""Backbone model (a port of ``repro.models.transformer``): the dense
family (uniform window, or grouped local:global à la gemma3), the MoE
family (decoder blocks with an MoE FFN, whose router aux loss is summed
over the layers) and the SSM family.

Entry points:
  init(gen) -> params                   # drawn on the generator's device
  apply(params, tokens, ...)            # full-sequence forward
  prefill(params, tokens, ...)          # forward + decode-cache build
  init_cache(batch, seq)                # zeroed decode cache
  decode(params, token, cache, index)   # ONE-token serve step

Parameters keep the reference's pytree: stacked layer params with their
leading ``(L,)`` or ``(G, r)`` dims, so the conversion from the reference
is leaf by leaf.  The reference's ``lax.scan`` over a stack is a Python
loop over its leading dim here.  ``ring_cache=True`` gives the
sliding-window layers O(W) ring-buffer caches.  The families hybrid,
audio and vlm belong to ROADMAP queue 1, slice 5 and raise.  The
reference's ``remat`` (``jax.checkpoint`` over the scan bodies) has no
counterpart: ``torch.utils.checkpoint`` does not compose with the
``torch.func.vmap`` of the agents' gradients, and it changes no number.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import nn, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Attention, SwiGLU, make_norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2Block
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

_LATER = "ROADMAP queue 1, slice 5 (hybrid, audio and vlm)"


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


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# Decoder block: attention + (SwiGLU | MoE)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecoderBlock(nn.Module):
    cfg: ArchConfig
    use_moe: bool = False
    cross: bool = False
    causal: bool = True
    use_flash: bool = False

    def __post_init__(self):
        if self.cross:
            raise NotImplementedError(f"cross-attention blocks are not ported yet: {_LATER}")

    @property
    def attn(self):
        return Attention(self.cfg, causal=self.causal, use_flash=self.use_flash)

    @property
    def mlp(self):
        return MoE(self.cfg) if self.use_moe else SwiGLU(self.cfg)

    def init(self, gen):
        c = self.cfg
        return {"ln1": make_norm(c, c.d_model).init(gen),
                "attn": self.attn.init(gen),
                "ln2": make_norm(c, c.d_model).init(gen),
                "mlp": self.mlp.init(gen)}

    def _norm(self):
        return make_norm(self.cfg, self.cfg.d_model)

    def apply(self, params, h, *, window=None, return_kv=False):
        """-> (h, aux[, kv]); aux is the MoE router's loss, else a float32 0."""
        norm = self._norm()
        a = self.attn.apply(params["attn"], norm.apply(params["ln1"], h),
                            window=window, return_kv=return_kv)
        if return_kv:
            a, kv = a
        h = h + a
        m = self.mlp.apply(params["mlp"], norm.apply(params["ln2"], h))
        if self.use_moe:
            m, aux = m
        else:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        h = h + m
        if return_kv:
            return h, aux, kv
        return h, aux

    def decode(self, params, h, cache, index, *, window=None, ring=False, donate=False):
        norm = self._norm()
        x = norm.apply(params["ln1"], h)
        if ring:
            a, new_cache = self.attn.decode_ring(params["attn"], x, cache, index,
                                                 donate=donate)
        else:
            a, new_cache = self.attn.decode(params["attn"], x, cache, index,
                                            window=window, donate=donate)
        h = h + a
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

    def __post_init__(self):
        if self.cfg.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(f"the {self.cfg.family!r} family is not ported "
                                      f"yet: {_LATER}")

    # ---- structure helpers ----
    @property
    def grouped(self) -> bool:
        return self.cfg.local_global_ratio > 0

    @property
    def n_groups(self) -> int:
        c = self.cfg
        return c.num_layers // (c.local_global_ratio + 1) if self.grouped else 0

    @property
    def n_tail(self) -> int:
        c = self.cfg
        return c.num_layers % (c.local_global_ratio + 1) if self.grouped else 0

    def _block(self):
        return DecoderBlock(self.cfg, use_moe=self.cfg.num_experts > 0,
                            use_flash=self.use_flash)

    def _mamba(self):
        return MambaLayer(self.cfg, use_kernel=self.use_ssd_kernel)

    def _stack_local(self, layers):
        """Per-layer trees of the local layers, in group order -> one tree
        stacked with leading dims (n_groups, ratio)."""
        lead = (self.n_groups, self.cfg.local_global_ratio)
        return tree_map(lambda x: x.reshape(lead + tuple(x.shape[1:])), _stack(layers))

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
        return nn.Embedding(c.padded_vocab, c.d_model).apply(params["embed"], tokens).to(c.dtype)

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
        return logits.float()

    # ---- full-sequence forward ----
    def apply(self, params, tokens, *, collect_cache: bool = False,
              logits_mode: str = "full"):
        """Returns dict(hidden, logits, aux[, cache]).  ``logits_mode``:
        "full" (training), "last" (prefill — only the next-token logits), or
        "none"."""
        c = self.cfg
        h = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        caches: dict[str, Any] = {}
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
            caches["local"] = self._stack_local(local)
            caches["global"] = _stack(glob)
            if self.n_tail:
                caches["tail"] = _stack(tail)
        return h, total[0], caches

    # ---- prefill ----
    def prefill(self, params, tokens, *, max_seq: int = 0, logits_mode: str = "last"):
        """Full forward + decode-cache build.  ``max_seq > T`` right-pads the
        attention caches so ``decode`` can continue writing at index >= T."""
        out = self.apply(params, tokens, collect_cache=True, logits_mode=logits_mode)
        T = tokens.shape[1]
        if max_seq and max_seq > T:
            out["cache"] = _pad_attn_cache(out["cache"], max_seq - T)
        return out

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

        if c.family == "ssm":
            return {"blocks": stacked(Mamba2Block(c).init_cache(batch, device=dev),
                                      (c.num_layers,))}
        W = min(c.sliding_window, seq) if c.sliding_window > 0 else seq
        ring = self._ring

        def kv(lead, windowed):
            r = ring and windowed
            return stacked(Attention(c).init_cache(batch, W if r else seq, ring=r,
                                                   device=dev), lead)

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
        to its compiled decode (no cache copy in a tick)."""
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
        new_cache = {"local": self._stack_local(local), "global": _stack(glob)}
        if self.n_tail:
            new_cache["tail"] = _stack(tail)
        return h, new_cache
