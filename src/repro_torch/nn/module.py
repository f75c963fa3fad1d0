"""Functional layers on parameter dicts (a port of ``repro.nn.module``).

A module is a pair of plain functions

    params = module.init(generator)      # dict of tensors
    out    = module.apply(params, *xs)   # pure function of (params, inputs)

with the parameter keys and layouts of the JAX reference: Dense ``w`` is
``(in, out)``, conv weights are HWIO (WIO in 1-D), transpose-conv weights
HWOI, and activations NHWC (NWC in 1-D).  Inside, a layer permutes to
PyTorch's NCHW/OIHW (NCW/OIW) for the library call and back.  ``init`` draws on the CPU from an explicit
``torch.Generator`` on the generator's own device (same distributions as
the reference, different bits): a CPU generator draws on the CPU, and the
caller moves the parameters; a CUDA generator draws on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves

# ---------------------------------------------------------------------------
# initializers: fn(generator, shape) -> float32 tensor on gen.device
# ---------------------------------------------------------------------------


def glorot_uniform(gen, shape, in_axis=-2, out_axis=-1):
    limit = math.sqrt(6.0 / (shape[in_axis] + shape[out_axis]))
    return torch.empty(shape, device=gen.device).uniform_(-limit, limit, generator=gen)


def normal_init(stddev: float = 0.02):
    def init(gen, shape):
        return stddev * torch.randn(shape, generator=gen, device=gen.device)

    return init


def truncated_normal_init(stddev: float = 0.02):
    def init(gen, shape):
        return stddev * torch.nn.init.trunc_normal_(
            torch.empty(shape, device=gen.device), a=-2.0, b=2.0, generator=gen)

    return init


def fan_in_init(gen, shape):
    """LeCun-normal: stddev = 1/sqrt(fan_in) with fan_in = prod(shape[:-1])."""
    fan_in = max(math.prod(shape[:-1]), 1)
    return torch.randn(shape, generator=gen, device=gen.device) / math.sqrt(fan_in)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses provide init(generator) and apply(params, x)."""

    def init(self, gen: torch.Generator):  # pragma: no cover - abstract
        raise NotImplementedError

    def apply(self, params, *args):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, params, *args):
        return self.apply(params, *args)


@dataclasses.dataclass(frozen=True)
class Dense(Module):
    in_dim: int
    out_dim: int
    use_bias: bool = True
    init_fn: Callable = glorot_uniform
    dtype: Any = torch.float32

    def init(self, gen):
        p = {"w": self.init_fn(gen, (self.in_dim, self.out_dim)).to(self.dtype)}
        if self.use_bias:
            p["b"] = torch.zeros(self.out_dim, dtype=self.dtype, device=gen.device)
        return p

    def apply(self, params, x):
        y = x @ params["w"]
        if self.use_bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class Embedding(Module):
    vocab: int
    dim: int
    dtype: Any = torch.float32
    stddev: float = 0.02

    def init(self, gen):
        table = torch.randn((self.vocab, self.dim), generator=gen, device=gen.device)
        return {"table": (self.stddev * table).to(self.dtype)}

    def apply(self, params, ids):
        return params["table"][ids]


@dataclasses.dataclass(frozen=True)
class LayerNorm(Module):
    dim: int
    eps: float = 1e-5
    use_bias: bool = True
    dtype: Any = torch.float32

    def init(self, gen):
        p = {"scale": torch.ones(self.dim, dtype=self.dtype, device=gen.device)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.dim, dtype=self.dtype, device=gen.device)
        return p

    def apply(self, params, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mu).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * params["scale"].float()
        if self.use_bias:
            y = y + params["bias"].float()
        return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class RMSNorm(Module):
    """The reference's cast order: the mean square in float32, the inverse
    root cast to x's dtype before it scales x, then the scale in x's dtype."""

    dim: int
    eps: float = 1e-6
    dtype: Any = torch.float32

    def init(self, gen):
        return {"scale": torch.ones(self.dim, dtype=self.dtype, device=gen.device)}

    def apply(self, params, x):
        var = torch.square(x.float()).mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * params["scale"].to(x.dtype)


@dataclasses.dataclass(frozen=True)
class BatchNorm(Module):
    """Batch-statistics norm (training-mode BN, as in the paper's ACGAN
    nets), used in train and eval alike: FedGAN averages parameters, and
    per-agent running statistics would be a second state channel the paper
    does not model."""

    dim: int
    eps: float = 1e-5

    def init(self, gen):
        return {"scale": torch.ones(self.dim, device=gen.device),
                "bias": torch.zeros(self.dim, device=gen.device)}

    def apply(self, params, x):
        axes = tuple(range(x.dim() - 1))
        mu = torch.mean(x, dim=axes, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=axes, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * params["scale"] + params["bias"]


def _same_pads(size: int, k: int, s: int):
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class Conv2D(Module):
    """``jax.lax.conv_general_dilated`` with NHWC/HWIO/NHWC numbers."""

    in_ch: int
    out_ch: int
    kernel: tuple = (4, 4)
    stride: tuple = (2, 2)
    padding: str = "SAME"
    use_bias: bool = True

    def init(self, gen):
        p = {"w": fan_in_init(gen, (*self.kernel, self.in_ch, self.out_ch))}
        if self.use_bias:
            p["b"] = torch.zeros(self.out_ch, device=gen.device)
        return p

    def apply(self, params, x):
        h = _nchw(x)
        if self.padding == "SAME":
            (hl, hh), (wl, wh) = (_same_pads(h.shape[2 + i], self.kernel[i],
                                             self.stride[i]) for i in range(2))
            h = F.pad(h, (wl, wh, hl, hh))
        elif self.padding != "VALID":
            raise ValueError(f"padding must be SAME or VALID, got {self.padding!r}")
        y = _nhwc(F.conv2d(h, params["w"].permute(3, 2, 0, 1), stride=self.stride))
        if self.use_bias:
            y = y + params["b"]
        return y


def _ncw(x):
    return x.permute(0, 2, 1)


@dataclasses.dataclass(frozen=True)
class Conv1D(Module):
    """``jax.lax.conv_general_dilated`` with NWC/WIO/NWC numbers: x (B, T,
    C), weights (kernel, in, out).  ``F.conv1d`` takes NCW and (out, in,
    kernel), so the layer permutes around the call, and SAME pads the time
    axis as XLA does (kernel 5 at stride 1: 2 and 2; kernel 1: none)."""

    in_ch: int
    out_ch: int
    kernel: int = 5
    stride: int = 1
    padding: str = "SAME"
    use_bias: bool = True

    def init(self, gen):
        p = {"w": fan_in_init(gen, (self.kernel, self.in_ch, self.out_ch))}
        if self.use_bias:
            p["b"] = torch.zeros(self.out_ch, device=gen.device)
        return p

    def apply(self, params, x):
        h = _ncw(x)
        if self.padding == "SAME":
            h = F.pad(h, _same_pads(h.shape[2], self.kernel, self.stride))
        elif self.padding != "VALID":
            raise ValueError(f"padding must be SAME or VALID, got {self.padding!r}")
        y = _ncw(F.conv1d(h, params["w"].permute(2, 1, 0), stride=self.stride))
        if self.use_bias:
            y = y + params["b"]
        return y


def _transpose_pads(k: int, s: int, padding: str):
    """``jax.lax.conv_transpose``'s padding of the lhs-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return pad_a, pad_len - pad_a


@dataclasses.dataclass(frozen=True)
class ConvTranspose2D(Module):
    """``jax.lax.conv_transpose`` with NHWC/HWOI/NHWC numbers and
    ``transpose_kernel=False``: the input is dilated by the stride, padded,
    and correlated with the kernel as it is, unflipped.  ``F.conv_transpose2d``
    flips the kernel, so the kernel is flipped once more on the way in; its
    padding p pads the dilated input by k - 1 - p below and by that plus
    ``output_padding`` above."""

    in_ch: int
    out_ch: int
    kernel: tuple = (4, 4)
    stride: tuple = (2, 2)
    padding: str = "SAME"
    use_bias: bool = True

    def init(self, gen):
        p = {"w": fan_in_init(gen, (*self.kernel, self.out_ch, self.in_ch))}
        if self.use_bias:
            p["b"] = torch.zeros(self.out_ch, device=gen.device)
        return p

    def apply(self, params, x):
        pads, out_pads = [], []
        for k, s in zip(self.kernel, self.stride):
            lo, hi = _transpose_pads(k, s, self.padding)
            if not (0 <= k - 1 - lo and 0 <= hi - lo < s):
                raise ValueError(f"conv_transpose padding ({lo}, {hi}) at "
                                 f"kernel {k}, stride {s} has no torch form")
            pads.append(k - 1 - lo)
            out_pads.append(hi - lo)
        w = params["w"].permute(3, 2, 0, 1).flip(2, 3)   # HWOI -> (I, O, kH, kW)
        y = _nhwc(F.conv_transpose2d(_nchw(x), w, stride=self.stride,
                                     padding=pads, output_padding=out_pads))
        if self.use_bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class Sequential(Module):
    layers: Sequence[Any]  # mix of Modules and bare callables (activations)

    def init(self, gen):
        return [layer.init(gen) if isinstance(layer, Module) else {}
                for layer in self.layers]

    def apply(self, params, x):
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x) if isinstance(layer, Module) else layer(x)
        return x


def leaky_relu(slope: float = 0.2):
    """``jax.nn.leaky_relu``: x where x >= 0, else slope·x.  Its gradient
    at exactly 0 is 1, as the reference's; ``F.leaky_relu``'s is the slope,
    which a batch norm over one example (DP-SGD's per-example gradients:
    its output is then exactly its shift, 0 at init) reaches on every
    element."""
    return lambda x: torch.where(x >= 0, x, slope * x)


def param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
