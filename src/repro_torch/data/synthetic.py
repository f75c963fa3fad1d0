"""Synthetic class-conditional images, the MNIST/CIFAR stand-in of the
image experiments (a port of ``repro.data.synthetic.sample_class_images``;
the other generators are not ported yet).  Draws come from an explicit
``torch.Generator`` on the labels' device: the same distributions as the
reference, different bits."""
from __future__ import annotations

import math

import torch


def sample_class_images(gen: torch.Generator, n: int, labels: torch.Tensor, *,
                        hw: int = 32, channels: int = 3, num_classes: int = 10):
    """Class c renders an oriented sinusoidal grating (orientation and
    frequency indexed by the class) with a class-colored gradient, plus
    instance noise.  Output in [-1, 1], NHWC, on ``labels.device``."""
    dev = labels.device
    axis = torch.linspace(-1, 1, hw, device=dev)
    yy, xx = torch.meshgrid(axis, axis, indexing="ij")
    lab = labels.to(torch.float32)
    theta = lab * (math.pi / num_classes)                              # (n,)
    freq = 2.0 + (labels % 5).to(torch.float32)                        # (n,)
    proj = (torch.cos(theta)[:, None, None] * xx[None]
            + torch.sin(theta)[:, None, None] * yy[None])              # (n,hw,hw)
    phase = 2 * math.pi * torch.rand((n, 1, 1), generator=gen, device=dev)
    base = torch.sin(freq[:, None, None] * math.pi * proj + phase)     # (n,hw,hw)
    col_ang = lab * (2 * math.pi / num_classes)
    cols = torch.stack([torch.cos(col_ang), torch.cos(col_ang + 2.1),
                        torch.cos(col_ang + 4.2)], dim=-1)             # (n,3)
    img = base[..., None] * (0.6 + 0.4 * cols[:, None, None, :])
    img = img[..., :channels]
    img = img + 0.15 * torch.randn(img.shape, generator=gen, device=dev)
    shift = 0.1 * torch.randn((n, 1, 1, channels), generator=gen, device=dev)
    return torch.clamp(img + shift, -1.0, 1.0)
