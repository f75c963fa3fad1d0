"""Per-agent DP-SGD: per-example clipping and Gaussian noise inside
``FedGAN._step`` (a port of ``repro.privacy.dpsgd``).

Each agent's minibatch gradient is replaced by the Gaussian mechanism:

    g = mean_i( clip_C(grad_i) ) + N(0, (sigma·C / n)^2)

where grad_i is the gradient of example i alone, C the clip norm, sigma
the noise multiplier and n the per-agent batch size.  A step releases both
players' gradients from one batch, so the pair is one release: the (G, D)
per-example gradient is clipped jointly to C (one ``clip_by_global_norm``
over both trees), the per-example sensitivity of the pair is C, and the
noise on every coordinate of the mean is a single Gaussian mechanism at
multiplier sigma, which :meth:`DPSGD.epsilon` composes over the steps.

Per-example gradients are ``torch.func.vmap`` over the example axis, each
example wrapped back into a batch of one (a batch-mean loss is unchanged),
nested inside the agent vmap of the local step.  A batch norm then sees
one example: its variance is 0 and its output the shift, as in the
reference.

Noise: the port's losses take no random state, so it has no per-agent
step keys.  ``FedGAN`` draws the standard normals outside the vmaps from
the round's ``torch.Generator`` on the params' device, one (P, A, ...)
tensor per leaf, the discriminator's leaves then the generator's, after
each step's minibatch draws (``FedGAN.step_noise``), and ``dp_grads``
scales them by sigma·C/n.  The bits differ from the reference's
``jax.random.normal`` of its step keys (a deliberate divergence, ROADMAP
§3); the law is the same.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from repro_torch.optim import clip_by_global_norm, global_norm
from repro_torch.privacy import accountant
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class DPSGD:
    """Per-agent DP-SGD config, the privacy axis of ``FedGANConfig``.

    ``clip``: per-example global-norm bound C on the joint (G, D) gradient.
    ``noise_multiplier``: sigma; the noise std is sigma·C/n per coordinate
    of the mean gradient.  0 disables noise (clip only: no epsilon).
    ``delta``: the delta at which :meth:`epsilon` reports the spend.
    ``sample_rate``: the accountant's subsampling rate q; the driver
    (``repro_torch.run.driver.check_dp_sample_rate``) refuses a q below
    the pipeline's batch_size / min_i |R_i|.  The default q = 1 is always
    conservative."""

    clip: float = 1.0
    noise_multiplier: float = 0.0
    delta: float = 1e-5
    sample_rate: float = 1.0

    def validate(self):
        if self.clip <= 0:
            raise ValueError(f"DPSGD clip must be > 0, got {self.clip}")
        if self.noise_multiplier < 0:
            raise ValueError(f"DPSGD noise_multiplier must be >= 0, "
                             f"got {self.noise_multiplier}")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(f"DPSGD sample_rate must be in (0, 1], "
                             f"got {self.sample_rate}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"DPSGD delta must be in (0, 1), "
                             f"got {self.delta}")

    def epsilon(self, steps: int) -> float:
        """Privacy spent after ``steps`` local steps (inf when sigma = 0)."""
        return accountant.epsilon(noise_multiplier=self.noise_multiplier,
                                  steps=steps, sample_rate=self.sample_rate,
                                  delta=self.delta)


def _clipped(grad_fn, params, batch, clip: float):
    """The gradients of ``batch`` (one example, in a batch of one), their
    pre-clip norms and metrics, the pair clipped jointly to ``clip``."""
    gd, gg, m = grad_fn(params, batch)
    nd, ng = global_norm(gd), global_norm(gg)
    (gd, gg), _ = clip_by_global_norm((gd, gg), clip)
    return gd, gg, nd, ng, m


def per_example_grads(grad_fn, params, batch, clip: float):
    """Per-example clipped gradients of one agent.

    ``grad_fn(params, batch) -> (grad_disc, grad_gen, metrics)`` is the
    agent's minibatch gradient function; it runs per example (a vmap over
    the leading batch axis, each example wrapped back into a batch of
    one).  Returns ``(gd, gg, norms_d, norms_g, metrics)`` with a leading
    example axis on everything.  The clip is one ``clip_by_global_norm``
    over (gd, gg), so each example's joint gradient has global norm <=
    clip; ``norms_d`` and ``norms_g`` are the pre-clip norms of each
    player."""
    return vmap(lambda ex: _clipped(grad_fn, params, tree_map(lambda v: v[None], ex), clip))(
        batch)


def noise_like(tree, gen: torch.Generator, std: float = 1.0):
    """Gaussian noise of std ``std`` shaped like ``tree``, drawn from
    ``gen`` leaf by leaf in leaf order (the same generator state gives the
    same bits)."""
    return tree_map(lambda x: std * torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                                device=x.device), tree)


def dp_grads(grad_fn, params, batch, dp: DPSGD, noise=None):
    """One agent's DP-SGD gradient: per-example clip, mean, noise.

    ``noise``: None (clip only) or ``(noise_d, noise_g)``, standard normals
    shaped like the two gradient trees, which are scaled by sigma·C/n and
    added to the means.  Returns ``(gd, gg, metrics)`` as ``grad_fn`` does,
    with the mean pre-clip per-example norms added to the metrics
    (``dp_grad_norm_d``, ``dp_grad_norm_g``)."""
    gd, gg, nd, ng, m = per_example_grads(grad_fn, params, batch, dp.clip)
    n = tree_leaves(batch)[0].shape[0]
    gd = tree_map(lambda g: torch.mean(g, dim=0), gd)
    gg = tree_map(lambda g: torch.mean(g, dim=0), gg)
    if noise is not None:
        std = dp.noise_multiplier * dp.clip / n
        gd = tree_map(lambda g, z: g + std * z, gd, noise[0])
        gg = tree_map(lambda g, z: g + std * z, gg, noise[1])
    metrics = tree_map(lambda v: torch.mean(v, dim=0), m)
    metrics = {**metrics, "dp_grad_norm_d": torch.mean(nd),
               "dp_grad_norm_g": torch.mean(ng)}
    return gd, gg, metrics


def dp_grads_on_mesh(grad_fn, params, batch, dp: DPSGD, noise=None, batch_dims=()):
    """``dp_grads`` of one agent whose work a submesh of several ranks
    splits (DTensor ``params`` and ``batch`` on the agent's submesh).

    ``batch_dims`` (the submesh dims that shard ``batch``, over which the
    weights are gathered: data parallelism inside the agent) are made
    manual: each rank takes the per-example clipped gradients of its own
    examples, sums them, and the sums are added across those dims before
    the mean.  What is left of the submesh is tensor parallelism: there the
    examples run one at a time by ``torch.autograd`` on the DTensors
    (``repro_torch.dist.sharding.grad_and_value`` says why), so each
    example's norm is that of its whole gradient, the shards of every rank
    included; with nothing left, the local tensors take the vmap of
    ``per_example_grads``.  ``noise`` is placed as the weights in use, so
    every coordinate gets its own noise once."""
    from repro_torch.dist.sharding import AgentShards, is_sharded
    n = tree_leaves(batch)[0].shape[0]
    view = None
    if batch_dims:
        view = AgentShards(tree_leaves(params)[0].device_mesh, batch_dims)
        params, batch = view.local(params), view.local(batch)
    if any(is_sharded(x) for x in tree_leaves(params)):
        total = None
        for i in range(tree_leaves(batch)[0].shape[0]):
            one = _clipped(grad_fn, params, tree_map(lambda v: v[i:i + 1], batch), dp.clip)
            total = one if total is None else tree_map(torch.add, total, one)
    else:
        total = tree_map(lambda v: torch.sum(v, dim=0),
                         per_example_grads(grad_fn, params, batch, dp.clip))
    if view is not None:
        total = view.summed(total)
    gd, gg, nd, ng, m = tree_map(lambda v: v / n, total)
    if noise is not None:
        std = dp.noise_multiplier * dp.clip / n
        gd = tree_map(lambda g, z: g + std * z, gd, noise[0])
        gg = tree_map(lambda g, z: g + std * z, gg, noise[1])
    return gd, gg, {**m, "dp_grad_norm_d": nd, "dp_grad_norm_g": ng}
