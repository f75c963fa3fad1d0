"""Synthetic data standing in for the paper's gated datasets (a port of
``repro.data.synthetic``): the exact toy distributions (2D segments, the
8-mode ring of Gaussians, the Swiss roll), class-conditional images (the
MNIST/CIFAR and CelebA stand-ins), daily household-load profiles (the
PG&E stand-in) and EV charging sessions.  Draws come from an explicit ``torch.Generator`` on its
own device (on the labels' device for the conditional ones): the same
distributions as the reference, different bits.  The LM GAN's token
streams (``sample_agent_tokens``) are the exception: they are the
reference's tokens bit for bit, drawn through the numpy Threefry of
``repro_torch.prng``."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import prng


# ---------------------------------------------------------------------------
# Toy distributions (§4.1 / Appendix C)
# ---------------------------------------------------------------------------


def sample_2d_segment(gen: torch.Generator, n: int, agent: int, num_agents: int = 5):
    """Agent i's real data: uniform on its 2/num_agents-wide slice of [-1,1]."""
    width = 2.0 / num_agents
    lo = -1.0 + width * agent
    u = torch.rand((n,), generator=gen, device=gen.device)
    return lo + width * u


def mixed_gaussian_modes(num_modes: int = 8, radius: float = 2.0, device="cpu"):
    ang = torch.arange(num_modes, device=device) * (2 * math.pi / num_modes)
    return torch.stack([radius * torch.cos(ang), radius * torch.sin(ang)], dim=-1)


def sample_mixed_gaussian(gen: torch.Generator, n: int, modes=None,
                          std: float = 0.05, mode_subset=None):
    """8 Gaussians on a circle (Metz et al.).  ``mode_subset`` restricts to
    an agent's local modes (non-iid split: 2 modes per agent for B=4)."""
    dev = gen.device
    modes = mixed_gaussian_modes(device=dev) if modes is None else modes.to(dev)
    if mode_subset is not None:
        modes = modes[torch.as_tensor(mode_subset, device=dev)]
    idx = torch.randint(0, modes.shape[0], (n,), generator=gen, device=dev)
    return modes[idx] + std * torch.randn((n, 2), generator=gen, device=dev)


def sample_swiss_roll(gen: torch.Generator, n: int, *, noise: float = 0.05,
                      t_range=(0.25, 1.0)):
    """2-D Swiss roll (Gulrajani et al.).  ``t_range`` in (0,1] selects the
    arc segment: agents get disjoint, equal-sized parts of the roll."""
    dev = gen.device
    t0, t1 = t_range
    t = 3 * math.pi * (t0 + (t1 - t0) * torch.rand((n,), generator=gen, device=dev))
    pts = torch.stack([t * torch.cos(t), t * torch.sin(t)], dim=-1) / (3 * math.pi)
    return pts + noise * torch.randn((n, 2), generator=gen, device=dev)


# ---------------------------------------------------------------------------
# Synthetic class-conditional images (MNIST/CIFAR and CelebA stand-ins)
# ---------------------------------------------------------------------------


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


def sample_attribute_faces(gen: torch.Generator, n: int, attrs: torch.Tensor, *,
                           hw: int = 32):
    """CelebA stand-in: 4 binary attributes -> 16 'identity classes'
    (Eyeglasses, Male, Smiling, Young in the paper).  ``attrs``: (n,) in
    [0, 16), on the generator's device."""
    return sample_class_images(gen, n, attrs, hw=hw, channels=3, num_classes=16)


# ---------------------------------------------------------------------------
# Synthetic time series (PG&E household load / EV charging sessions)
# ---------------------------------------------------------------------------


def sample_household_load(gen: torch.Generator, n: int, *, climate_zone: torch.Tensor,
                          seq_len: int = 24):
    """Daily household consumption profile, normalised to a peak of 1.

    Morning and evening peaks whose relative magnitude and timing depend on
    the climate zone (the non-iid split key of §4.3), plus weekday noise.
    ``climate_zone``: (n,) int in [0, 5), on the generator's device."""
    dev = gen.device
    cz = climate_zone.to(torch.float32)[:, None]
    t = torch.arange(seq_len, dtype=torch.float32, device=dev)[None, :]   # hours
    morning_peak = 6.5 + 0.5 * cz + 0.5 * torch.randn((n, 1), generator=gen, device=dev)
    evening_peak = 18.0 + 0.4 * cz + 0.5 * torch.randn((n, 1), generator=gen, device=dev)
    morning_h = 0.4 + 0.1 * cz
    evening_h = 1.0 - 0.08 * cz
    base = 0.25 + 0.03 * cz
    prof = (base
            + morning_h * torch.exp(-0.5 * ((t - morning_peak) / 1.5) ** 2)
            + evening_h * torch.exp(-0.5 * ((t - evening_peak) / 2.0) ** 2))
    prof = prof + 0.05 * torch.randn((n, seq_len), generator=gen, device=dev)
    return prof / prof.amax(dim=1, keepdim=True)


def sample_ev_sessions(gen: torch.Generator, n: int, *, category: torch.Tensor,
                       seq_len: int = 24):
    """EV charging power profile over 24 hourly bins, normalised to a peak
    of 1 (0 stays 0).  ``category`` (the station's point of interest, (n,)
    int on the generator's device): 0 high-tech workplace (day charging),
    1 shopping (till midnight), 2 municipal, 3 retail, 4 residential
    (overnight), the contrast of the paper's Fig. 10."""
    dev = gen.device
    cat = category.to(torch.int64)
    t = torch.arange(seq_len, dtype=torch.float32, device=dev)[None, :]
    starts = torch.tensor([8.5, 16.0, 10.0, 12.0, 21.0], device=dev)[cat][:, None]
    durs = torch.tensor([4.0, 5.0, 3.0, 2.0, 7.0], device=dev)[cat][:, None]
    start = starts + 1.0 * torch.randn((n, 1), generator=gen, device=dev)
    dur = torch.clamp(durs + 0.8 * torch.randn((n, 1), generator=gen, device=dev), min=0.5)
    ramp = torch.sigmoid(2.0 * (t - start)) * torch.sigmoid(2.0 * (start + dur - t))
    power = ramp * (0.7 + 0.3 * torch.rand((n, 1), generator=gen, device=dev))
    peak = power.amax(dim=1, keepdim=True)
    return power / torch.where(peak == 0, torch.ones_like(peak), peak)


# ---------------------------------------------------------------------------
# Synthetic token streams (LM-backbone federated training)
# ---------------------------------------------------------------------------


def sample_agent_tokens(rng, n: int, seq_len: int, vocab: int, *, agent: int,
                        num_agents: int) -> torch.Tensor:
    """Non-iid token sequences, (n, seq_len) int32 on the CPU: each agent
    draws from a distinct slice of the vocabulary, 30% of the tokens from a
    head shared by all.  ``rng`` is a key's data (``prng.key(seed)``); the
    tokens are the reference's ``sample_agent_tokens(jax.random.key(seed),
    ...)`` bit for bit.  As there, the shared tokens and the choice of
    where they go are both drawn from the same key ``k2``."""
    k1, k2 = prng.split(prng.fold_in(rng, agent))
    shard = max(vocab // num_agents, 2)
    base = prng.randint(k1, (n, seq_len), 0, shard)
    offset = min(agent * shard, max(vocab - shard, 0))
    shared = prng.randint(k2, (n, seq_len), 0, vocab)
    use_shared = prng.uniform(k2, (n, seq_len)) < np.float32(0.3)
    return torch.from_numpy(np.where(use_shared, shared, base + offset).astype(np.int32))


def sample_audio_frames(seed: int, n: int, encoder_seq: int, d_model: int, *,
                        agent: int) -> torch.Tensor:
    """Stand-in encoder frames for the audio family's stubbed frontend,
    (n, encoder_seq, d_model) float32 on the CPU: 0.1 x standard normal,
    from numpy's generator seeded with (seed, 50 + agent).  The reference
    draws its frames from ``jax.random``; these are the port's own draws
    of the same distribution."""
    rng = np.random.default_rng((seed, 50 + agent))
    return torch.from_numpy(
        (0.1 * rng.standard_normal((n, encoder_seq, d_model))).astype(np.float32))
