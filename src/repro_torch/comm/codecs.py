"""Wire codecs for the compressed sync (a subset of ``repro.comm.codecs``).

``IntQuant`` is the block-scaled int8/int4 quantizer.  In this port it
runs only inside the fused sync (``kernels/qsync``): ``fused_sync_spec``
hands its knobs to the kernel, and the byte accounting (``payload_like``,
``meta_wire_bytes``, ``wire_bytes``) bills its wire exactly as the
reference does.  The standalone ``encode`` / ``decode`` / ``roundtrip``
need the qpack kernels and raise until those are ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

QPACK_SLICE = ("IntQuant.{} needs the qpack kernels (quantize, dequantize, "
               "int4 pack), which the port has not ported yet; the fused "
               "sync (kernels/qsync) runs without them")


class Like(NamedTuple):
    """Shape and dtype of a tensor that is described, not materialized."""

    shape: tuple
    dtype: torch.dtype


def _like_n(like) -> int:
    return int(math.prod(like.shape)) if len(like.shape) else 1


def _nbytes(like) -> int:
    return _like_n(like) * like.dtype.itemsize


class Codec:
    """Base protocol (see ``repro.comm.codecs.Codec``)."""

    name = "identity"

    def validate(self):
        pass

    def encode(self, x, batch_ndims: int = 0):
        raise NotImplementedError

    def decode(self, payload, meta, like, batch_ndims: int = 0):
        raise NotImplementedError

    def roundtrip(self, x, batch_ndims: int = 0):
        raise NotImplementedError

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
        roundtrip can run inside it, else None."""
        return None


@dataclasses.dataclass(frozen=True)
class IntQuant(Codec):
    """Block-scaled symmetric integer quantization (int8 or packed int4).

    Each ``block``-wide tile of the flattened leaf gets one f16 scale
    (max-abs / qmax); codes are round-half-to-even, clipped to ±qmax.  Wire
    = ``ceil(N·bits/8)`` payload bytes + 2 bytes per block for the scale.
    Lossy: pair it with error feedback (the strategy default)."""

    bits: int = 8
    block: int = 128

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
        raise NotImplementedError(QPACK_SLICE.format("encode"))

    def decode(self, payload, meta, like, batch_ndims: int = 0):
        raise NotImplementedError(QPACK_SLICE.format("decode"))

    def roundtrip(self, x, batch_ndims: int = 0):
        raise NotImplementedError(QPACK_SLICE.format("roundtrip"))

    def payload_like(self, like):
        # the wire ships the unpadded stream; padding to the block multiple
        # is a kernel-tiling artifact
        return Like(((_like_n(like) * self.bits + 7) // 8,), torch.int8)

    def fused_sync_spec(self):
        return {"bits": self.bits, "block": self.block}

    def meta_wire_bytes(self, like) -> int:
        n_blocks = -(-_like_n(like) // self.block)
        return n_blocks * torch.float16.itemsize
