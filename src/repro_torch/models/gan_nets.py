"""The paper's experiment networks, with the parameter dicts of
``repro.models.gan_nets``.

- 2D system (Appendix C / Nagarajan & Kolter):  D(x) = psi * x^2,  G(z) = theta * z.
- MLP GAN for mixed-Gaussian / Swiss-roll (Kodali et al. DRAGAN nets).
- ACGAN conv nets for the image experiments (Odena et al., Table 1/2), NHWC.
- CGAN with stacked 1-D convs for the time-series experiments (Table 3), NWC.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot by comparison (``F.one_hot`` inspects the values,
    which ``torch.func.vmap`` cannot batch)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


# ---------------------------------------------------------------------------
# 2D system: scalar generator/discriminator (exactly the paper's toy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Toy2DGenerator(nn.Module):
    """G(z) = theta * z, z ~ U[-1, 1]; ``theta`` is a 0-d leaf."""

    theta0: float = 0.1

    def init(self, gen):
        return {"theta": torch.tensor(self.theta0, dtype=torch.float32,
                                      device=gen.device)}

    def apply(self, params, z):
        return params["theta"] * z


@dataclasses.dataclass(frozen=True)
class Toy2DDiscriminator(nn.Module):
    """D(x) = psi * x^2 (the paper uses the quadratic discriminator)."""

    psi0: float = 0.1

    def init(self, gen):
        return {"psi": torch.tensor(self.psi0, dtype=torch.float32,
                                    device=gen.device)}

    def apply(self, params, x):
        return params["psi"] * torch.square(x)


# ---------------------------------------------------------------------------
# MLP GAN (mixed Gaussian / Swiss roll)
# ---------------------------------------------------------------------------


def _mlp(sizes):
    """Dense layers of ``sizes`` with a ReLU between each two."""
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers.append(nn.Dense(a, b))
        if i < len(sizes) - 2:
            layers.append(torch.relu)
    return nn.Sequential(layers)


@dataclasses.dataclass(frozen=True)
class MLPGenerator(nn.Module):
    latent_dim: int = 2
    out_dim: int = 2
    hidden: int = 128
    depth: int = 3

    def _net(self):
        return _mlp([self.latent_dim] + [self.hidden] * self.depth + [self.out_dim])

    def init(self, gen):
        return self._net().init(gen)

    def apply(self, params, z):
        return self._net().apply(params, z)


@dataclasses.dataclass(frozen=True)
class MLPDiscriminator(nn.Module):
    in_dim: int = 2
    hidden: int = 128
    depth: int = 3

    def _net(self):
        return _mlp([self.in_dim] + [self.hidden] * self.depth + [1])

    def init(self, gen):
        return self._net().init(gen)

    def apply(self, params, x):
        return self._net().apply(params, x)[..., 0]  # logits


# ---------------------------------------------------------------------------
# ACGAN conv nets (paper Table 1, CIFAR-10 / MNIST layout, NHWC)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# CGAN with 1-D convs (time-series, paper Table 3)
# ---------------------------------------------------------------------------


def _with_labels(x, labels, seq_len, label_dim):
    """(B, T) values + (B, label_dim) labels -> (B, T, 1 + label_dim), the
    labels broadcast along time."""
    lab = labels[:, None, :].expand(x.shape[0], seq_len, label_dim)
    return torch.cat([x[..., None], lab.to(x.dtype)], dim=-1)


@dataclasses.dataclass(frozen=True)
class CGAN1DGenerator(nn.Module):
    """(label, noise) channels x 24 steps -> 24-step profile.
    Table 3: conv1d(5,64) x ~8 with ReLU, then conv1d(1,1)."""

    seq_len: int = 24
    label_dim: int = 4
    hidden: int = 64
    depth: int = 8

    def _layers(self):
        layers = [nn.Conv1D(self.label_dim + 1, self.hidden)]
        for _ in range(self.depth):
            layers += [torch.relu, nn.Conv1D(self.hidden, self.hidden)]
        layers += [torch.relu, nn.Conv1D(self.hidden, 1, kernel=1)]
        return nn.Sequential(layers)

    def init(self, gen):
        return self._layers().init(gen)

    def apply(self, params, z, labels):
        # z: (B, T); labels: (B, label_dim) broadcast along time
        x = _with_labels(z, labels, self.seq_len, self.label_dim)
        return self._layers().apply(params, x)[..., 0]


@dataclasses.dataclass(frozen=True)
class CGAN1DDiscriminator(nn.Module):
    seq_len: int = 24
    label_dim: int = 4
    hidden: int = 64
    depth: int = 8

    def _layers(self):
        layers = [nn.Conv1D(self.label_dim + 1, self.hidden)]
        for _ in range(self.depth):
            layers += [torch.relu, nn.Conv1D(self.hidden, self.hidden)]
        return nn.Sequential(layers)

    def init(self, gen):
        return {"conv": self._layers().init(gen),
                "head": nn.Dense(self.hidden, 1).init(gen)}

    def apply(self, params, x, labels):
        h = _with_labels(x, labels, self.seq_len, self.label_dim)
        h = self._layers().apply(params["conv"], h)
        h = torch.mean(h, dim=1)  # pool over time
        return (h @ params["head"]["w"] + params["head"]["b"])[..., 0]
