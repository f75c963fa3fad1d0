"""The paper's ACGAN conv nets for the image experiments (Odena et al.,
Table 1), NHWC, with the parameter dicts of ``repro.models.gan_nets``.
The toy, MLP and 1-D CGAN nets are not ported yet."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot by comparison (``F.one_hot`` inspects the values,
    which ``torch.func.vmap`` cannot batch)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ACGANGenerator(nn.Module):
    """z (latent) + class label -> image.  Table 1: Linear 1024 -> Linear
    128*(H/4)*(W/4) -> convT 64 -> convT C, BN+ReLU, tanh output."""

    latent_dim: int = 62
    num_classes: int = 10
    image_hw: int = 32
    channels: int = 3
    base: int = 128

    def _seed_hw(self):
        return self.image_hw // 4

    def init(self, gen):
        s = self._seed_hw()
        in_dim = self.latent_dim + self.num_classes
        return {
            "fc1": nn.Dense(in_dim, 1024).init(gen),
            "bn1": nn.BatchNorm(1024).init(gen),
            "fc2": nn.Dense(1024, self.base * s * s).init(gen),
            "bn2": nn.BatchNorm(self.base * s * s).init(gen),
            "ct1": nn.ConvTranspose2D(self.base, 64).init(gen),
            "bn3": nn.BatchNorm(64).init(gen),
            "ct2": nn.ConvTranspose2D(64, self.channels).init(gen),
        }

    def apply(self, params, z, labels):
        h = torch.cat([z, one_hot(labels, self.num_classes)], dim=-1)
        h = torch.relu(nn.BatchNorm(1024).apply(
            params["bn1"], h @ params["fc1"]["w"] + params["fc1"]["b"]))
        h = torch.relu(nn.BatchNorm(1).apply(
            params["bn2"], h @ params["fc2"]["w"] + params["fc2"]["b"]))
        s = self._seed_hw()
        h = h.reshape(-1, s, s, self.base)
        h = torch.relu(nn.BatchNorm(64).apply(
            params["bn3"], nn.ConvTranspose2D(self.base, 64).apply(params["ct1"], h)))
        return torch.tanh(nn.ConvTranspose2D(64, self.channels).apply(params["ct2"], h))


@dataclasses.dataclass(frozen=True)
class ACGANDiscriminator(nn.Module):
    """Table 1 D: conv 64 -> conv 128(BN) -> Linear 1024(BN) -> heads
    (binary real/fake logit + aux class logits)."""

    num_classes: int = 10
    image_hw: int = 32
    channels: int = 3

    def init(self, gen):
        s = self.image_hw // 4
        return {
            "c1": nn.Conv2D(self.channels, 64).init(gen),
            "c2": nn.Conv2D(64, 128).init(gen),
            "bn2": nn.BatchNorm(128).init(gen),
            "fc": nn.Dense(128 * s * s, 1024).init(gen),
            "bn3": nn.BatchNorm(1024).init(gen),
            "head_bin": nn.Dense(1024, 1).init(gen),
            "head_cls": nn.Dense(1024, self.num_classes).init(gen),
        }

    def apply(self, params, img):
        lrelu = nn.leaky_relu(0.2)
        h = lrelu(nn.Conv2D(self.channels, 64).apply(params["c1"], img))
        h = lrelu(nn.BatchNorm(128).apply(params["bn2"],
                                          nn.Conv2D(64, 128).apply(params["c2"], h)))
        h = h.reshape(h.shape[0], -1)   # NHWC flatten, as the reference
        h = lrelu(nn.BatchNorm(1024).apply(params["bn3"],
                                           h @ params["fc"]["w"] + params["fc"]["b"]))
        logit = (h @ params["head_bin"]["w"] + params["head_bin"]["b"])[..., 0]
        cls = h @ params["head_cls"]["w"] + params["head_cls"]["b"]
        return logit, cls
