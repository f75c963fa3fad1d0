"""Composable wire codecs for the compressed sync (a port of
``repro.comm.codecs``).

A :class:`Codec` maps a float leaf to a wire representation and back:

  ``encode(x, batch_ndims)``   -> (payload, meta): the payload a further
                                  codec may re-encode (top-k values stay
                                  float; quantized codes are terminal), the
                                  meta the side information (scales,
                                  indices) that ships alongside
  ``decode(payload, meta, like, batch_ndims)``
                               -> the reconstruction shaped like ``like``
  ``roundtrip(x, batch_ndims)``-> decode(encode(x)), the lossy wire image
  ``wire_bytes(like)``         -> per-leaf wire size: final payload plus
                                  every stage's meta

The leading ``batch_ndims`` dims (the (P, A) agent grid when called from
``repro_torch.dist.collectives``) stay batch: blocks, scales and top-k
selections never span agents.  ``IntQuant`` runs on the qpack kernels
(``kernels/qpack``); its ``fused_sync_spec`` hands its knobs to the fused
sync (``kernels/qsync``), which the chains cannot ride.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.qpack.ops import (dequantize_blocks, quantize_blocks,
                                          roundtrip_blocks)


class Like(NamedTuple):
    """Shape and dtype of a tensor that is described, not materialized."""

    shape: tuple
    dtype: torch.dtype


def _like_n(like) -> int:
    return int(math.prod(like.shape)) if len(like.shape) else 1


def _nbytes(like) -> int:
    return _like_n(like) * like.dtype.itemsize


class Codec:
    """Base protocol (see ``repro.comm.codecs.Codec``).  ``chainable`` marks
    codecs whose payload is still a float stream a further codec can
    re-encode (quantized codes are not)."""

    name = "identity"
    chainable = True

    def validate(self):
        pass

    def encode(self, x, batch_ndims: int = 0):
        raise NotImplementedError

    def decode(self, payload, meta, like, batch_ndims: int = 0):
        raise NotImplementedError

    def roundtrip(self, x, batch_ndims: int = 0):
        payload, meta = self.encode(x, batch_ndims)
        like = Like(tuple(x.shape[batch_ndims:]), x.dtype)
        return self.decode(payload, meta, like, batch_ndims)

    def payload_like(self, like):
        """Per-leaf (no batch dims) shape/dtype of the encoded payload."""
        raise NotImplementedError

    def meta_wire_bytes(self, like) -> int:
        """Wire bytes of this stage's side information for one leaf."""
        raise NotImplementedError

    def wire_bytes(self, like) -> int:
        """Total per-leaf wire bytes: payload + all meta."""
        return self.meta_wire_bytes(like) + _nbytes(self.payload_like(like))

    def fused_sync_spec(self):
        """Kwargs for the fused sync (``kernels/qsync``) when this codec's
        roundtrip can run inside it, else None.  Only the plain block
        quantizer qualifies: chains and sparsifiers reshape the payload and
        take the composed per-leaf pipeline."""
        return None


def _flat(x, batch_ndims: int):
    lead = tuple(x.shape[:batch_ndims])
    return x.reshape(lead + (-1,)), lead


@dataclasses.dataclass(frozen=True)
class IntQuant(Codec):
    """Block-scaled symmetric integer quantization (int8 or packed int4).

    Each ``block``-wide tile of the flattened leaf gets one f16 scale
    (max-abs / qmax); codes are round-half-to-even, clipped to ±qmax.  Wire
    = ``ceil(N·bits/8)`` payload bytes + 2 bytes per block for the scale.
    Lossy: pair it with error feedback (the strategy default)."""

    bits: int = 8
    block: int = 128

    chainable = False

    @property
    def name(self):
        return f"int{self.bits}"

    def validate(self):
        if self.bits not in (4, 8):
            raise ValueError(f"IntQuant bits must be 4 or 8, got {self.bits}")
        if self.block < 2 or self.block % 2:
            raise ValueError(f"IntQuant block must be even and >= 2, "
                             f"got {self.block}")

    def encode(self, x, batch_ndims: int = 0):
        flat, _ = _flat(x, batch_ndims)
        payload, scales = quantize_blocks(flat, bits=self.bits, block=self.block)
        return payload, {"scale": scales}

    def decode(self, payload, meta, like, batch_ndims: int = 0):
        out = dequantize_blocks(payload, meta["scale"], n=_like_n(like),
                                bits=self.bits, block=self.block)
        lead = tuple(payload.shape[:batch_ndims])
        return out.reshape(lead + tuple(like.shape)).to(like.dtype)

    def roundtrip(self, x, batch_ndims: int = 0):
        # the wire image without the int4 nibble pack / unpack, a bit-exact
        # identity: quantize then dequantize, two launches
        flat, _ = _flat(x, batch_ndims)
        out = roundtrip_blocks(flat, bits=self.bits, block=self.block)
        return out.reshape(x.shape).to(x.dtype)

    def payload_like(self, like):
        # the wire ships the unpadded stream; padding to the block multiple
        # is a kernel-tiling artifact
        return Like(((_like_n(like) * self.bits + 7) // 8,), torch.int8)

    def fused_sync_spec(self):
        return {"bits": self.bits, "block": self.block}

    def meta_wire_bytes(self, like) -> int:
        n_blocks = -(-_like_n(like) // self.block)
        return n_blocks * torch.float16.itemsize


@dataclasses.dataclass(frozen=True)
class TopK(Codec):
    """Magnitude top-k sparsification: keep the ``fraction`` largest-|x|
    entries of each (per-agent) leaf, zero the rest.  Wire = k values at
    the leaf dtype + k int32 indices.  The values stay float, so a
    quantizer can chain behind it (``Sequential((TopK(...), IntQuant(...)))``).

    Among equal magnitudes the lower index is kept first, as
    ``jax.lax.top_k`` does: the selection is the head of a stable
    descending sort (``torch.topk`` promises no order among ties, and
    zero-initialised biases are all ties)."""

    fraction: float = 0.1

    name = "topk"

    def validate(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"TopK fraction must be in (0, 1], "
                             f"got {self.fraction}")

    def _k(self, n: int) -> int:
        return max(1, min(n, math.ceil(self.fraction * n)))

    def encode(self, x, batch_ndims: int = 0):
        flat, _ = _flat(x, batch_ndims)
        k = self._k(flat.shape[-1])
        order = torch.sort(flat.abs(), dim=-1, descending=True, stable=True)[1]
        idx = order[..., :k]
        return torch.gather(flat, -1, idx), {"idx": idx.to(torch.int32)}

    def decode(self, payload, meta, like, batch_ndims: int = 0):
        n = _like_n(like)
        lead = tuple(payload.shape[:batch_ndims])
        rows = math.prod(lead)
        v = payload.reshape(rows, -1)
        i = meta["idx"].reshape(rows, -1).long()
        out = torch.zeros((rows, n), dtype=payload.dtype, device=payload.device)
        out.scatter_(1, i, v)
        return out.reshape(lead + tuple(like.shape)).to(like.dtype)

    def payload_like(self, like):
        return Like((self._k(_like_n(like)),), like.dtype)

    def meta_wire_bytes(self, like) -> int:
        return self._k(_like_n(like)) * torch.int32.itemsize


@dataclasses.dataclass(frozen=True)
class Sequential(Codec):
    """Chain codecs left to right: each stage re-encodes the previous
    stage's payload (e.g. sparsify, then quantize the survivors).  Wire =
    the final payload + every stage's meta."""

    codecs: tuple = ()

    @property
    def name(self):
        return "+".join(c.name for c in self.codecs)

    @property
    def chainable(self):
        return self.codecs[-1].chainable if self.codecs else True

    def validate(self):
        if not self.codecs:
            raise ValueError("Sequential needs at least one codec")
        for c in self.codecs:
            c.validate()
        for c in self.codecs[:-1]:
            if not c.chainable:
                raise ValueError(
                    f"{c.name} produces integer codes; it can only be the "
                    f"last stage of a chain (got {self.name})")

    def _likes(self, like):
        """Per-stage input likes: like -> c0.payload_like -> c1 ..."""
        likes = [like]
        for c in self.codecs[:-1]:
            likes.append(c.payload_like(likes[-1]))
        return likes

    def encode(self, x, batch_ndims: int = 0):
        payload, metas = x, []
        for c in self.codecs:
            payload, m = c.encode(payload, batch_ndims)
            metas.append(m)
        return payload, {"stages": tuple(metas)}

    def decode(self, payload, meta, like, batch_ndims: int = 0):
        for c, m, lk in zip(reversed(self.codecs), reversed(meta["stages"]),
                            reversed(self._likes(like))):
            payload = c.decode(payload, m, lk, batch_ndims)
        return payload

    def payload_like(self, like):
        return self.codecs[-1].payload_like(self._likes(like)[-1])

    def meta_wire_bytes(self, like) -> int:
        return sum(c.meta_wire_bytes(lk)
                   for c, lk in zip(self.codecs, self._likes(like)))


# ---------------------------------------------------------------------------
# Registry + CLI resolution
# ---------------------------------------------------------------------------

CODECS = {
    "int8": lambda: IntQuant(bits=8),
    "int4": lambda: IntQuant(bits=4),
    "topk": lambda: TopK(),
}


def _stages(spec: str, *, bits: int = 0, fraction: float = 0.0,
            block: int = 0) -> list:
    """Spec string -> list of codec stages with knob overrides applied."""
    stages = []
    for part in [p for p in spec.split("+") if p]:
        try:
            c = CODECS[part]()
        except KeyError:
            raise ValueError(f"unknown codec {part!r}; "
                             f"known: {sorted(CODECS)}") from None
        if isinstance(c, IntQuant):
            c = dataclasses.replace(c, bits=bits or c.bits,
                                    block=block or c.block)
        if isinstance(c, TopK) and fraction:
            c = dataclasses.replace(c, fraction=fraction)
        stages.append(c)
    return stages


def _chain(stages, spec):
    if not stages:
        raise ValueError(f"empty codec spec {spec!r}")
    codec = stages[0] if len(stages) == 1 else Sequential(tuple(stages))
    codec.validate()
    return codec


def get_codec(spec: str, *, bits: int = 0, fraction: float = 0.0,
              block: int = 0) -> Codec:
    """Resolve a codec spec string (a registry name or a ``+``-chain like
    ``"topk+int8"``) with optional knob overrides applied to the matching
    stage(s)."""
    return _chain(_stages(spec, bits=bits, fraction=fraction, block=block),
                  spec)


def codec_from_flags(spec: str = "", bits: int = 0,
                     topk: float = 0.0) -> Codec | None:
    """CLI flags -> codec.  ``--codec`` names the spec; ``--codec-bits``
    retunes (or appends) the quantizer stage; ``--topk`` retunes (or
    prepends) the sparsifier, so ``--codec int4 --topk 0.25`` is the
    sparsify-then-quantize chain.  None when no codec flag was given."""
    if not spec and not bits and not topk:
        return None
    stages = _stages(spec, bits=bits, fraction=topk)
    if spec and not stages:
        raise ValueError(f"empty codec spec {spec!r}")
    if topk and not any(isinstance(c, TopK) for c in stages):
        stages.insert(0, TopK(fraction=topk))
    if bits and not any(isinstance(c, IntQuant) for c in stages):
        stages.append(IntQuant(bits=bits))
    return _chain(stages, spec)
