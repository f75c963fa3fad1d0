"""Convergence-theory instrumentation (paper §3.3, Lemmas 1 and 2; a port
of ``repro.core.convergence``).

For equal time scales and a learning rate a(n) constant within a sync
interval the paper bounds:

  Lemma 1 (agent drift from the virtual centralized sequence (v_n, phi_n)):
      E||w_n^i - v_n|| + E||th_n^i - ph_n||
          <= r1(n) = (sg + mg + sh)/(2L) * [(1 + 2 a L)^(n mod K) - 1]

  Lemma 2 (drift of the synced average):
      E||w_n - v_n|| + E||th_n - ph_n||
          <= r2(n) = (sg + sh + mg)/(2L) * [(1 + 2 a L)^K - 1] - a mg K

with the (A5) constants sg, sh (stochastic-gradient deviation bounds), mg
(the non-iid gradient divergence bound) and L the Lipschitz constant (A1).

This module gives the two bounds, estimators of (L, sg, sh, mg) from a
``GANTask`` and per-agent data, and a harness that runs FedGAN beside the
virtual centralized SGD of eq. (7) and measures the drift.  Everything
here runs op by op on the host's loop; it is for small models.

Minibatch indices come from ``repro_torch.prng.randint`` under the
reference's key schedule (``split``, ``fold_in``), so sg, sh and mg are
the reference's on the same data.  L's probe directions are numpy normals
seeded from the same keys, not ``jax.random.normal``'s bits: L is a
maximum over a few random directions, so it agrees with the reference's
only in law.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch.func import grad

from repro_torch import prng
from repro_torch.core.fedgan import FedGAN, GANTask
from repro_torch.dist import collectives
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def tree_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


def tree_diff_norm(a, b) -> torch.Tensor:
    return tree_norm(tree_map(lambda x, y: x - y, a, b))


# ---------------------------------------------------------------------------
# Lemma bounds
# ---------------------------------------------------------------------------

def _int_pow_f32(base, m):
    """``base ** m`` in float32 for integer m >= 0 by squaring: each set
    bit of m multiplies the square of its place in, as XLA's ``pow`` with
    an integer exponent computes it."""
    b = np.float32(base)
    m = np.asarray(m, np.int64)
    acc = np.ones(m.shape, np.float32)
    while (m > 0).any():
        acc = np.where(m & 1, acc * b, acc).astype(np.float32)
        b, m = np.float32(b * b), m >> 1
    return acc


def r1_bound(n, *, a, K, L, sg, sh, mg):
    """Lemma 1's right side at step n (a = a(n-1), constant within the
    interval).  float32, as the reference's: its step n is an integer
    array, so its power runs in float32 by squaring."""
    m = np.asarray(n) % K
    c = np.float32((sg + mg + sh) / (2 * L))
    return c * (_int_pow_f32(1 + 2 * a * L, m) - np.float32(1.0))


def r2_bound(n, *, a, K, L, sg, sh, mg):
    """Lemma 2's right side (uniform over the interval), in Python floats
    as the reference's."""
    return ((sg + sh + mg) / (2 * L) * ((1 + 2 * a * L) ** K - 1.0) - a * mg * K)


# ---------------------------------------------------------------------------
# (A1)/(A5) constant estimation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstantEstimates:
    L: float
    sigma_g: float   # disc stochastic-gradient deviation bound
    sigma_h: float   # gen stochastic-gradient deviation bound
    mu_g: float      # non-iid gradient divergence bound (disc)


def _grads(task: GANTask, params, batch):
    gd = grad(lambda d: task.disc_loss({**params, "disc": d}, batch))(params["disc"])
    gg = grad(lambda g: task.gen_loss({**params, "gen": g}, batch))(params["gen"])
    return gd, gg


def _sample_minibatch(data, key, size):
    """``size`` examples of ``data`` drawn with replacement at the indices
    of ``jax.random.randint(key, (size,), 0, n)``."""
    n = tree_leaves(data)[0].shape[0]
    idx = torch.from_numpy(prng.randint(key, (size,), 0, n).astype(np.int64))
    return tree_map(lambda x: x[idx.to(x.device)], data)


def _weighted_sum(w, trees):
    return tree_map(lambda *xs: sum(float(wi) * x for wi, x in zip(w, xs)), *trees)


def estimate_constants(task: GANTask, params, agent_data: Sequence[Any], rng, *,
                       minibatch: int = 64, n_var_samples: int = 8,
                       n_lip_samples: int = 8, lip_eps: float = 1e-2,
                       weights=None) -> ConstantEstimates:
    """Empirical (A1)/(A5) constants at ``params``.

    ``agent_data[i]`` is agent i's whole local dataset (a batch tree);
    ``rng`` is key data (``repro_torch.prng.key``).  The pooled "true"
    gradient is the p_i-weighted mean of the per-agent full-data gradients
    (the gradient of the centralized loss on the pooled data)."""
    B = len(agent_data)
    w = np.full((B,), 1.0 / B, np.float32) if weights is None else np.asarray(weights, np.float32)

    rng, _ = prng.split(rng)      # the reference's loss key, unused here
    full = [_grads(task, params, data) for data in agent_data]
    pooled_gd = _weighted_sum(w, [gd for gd, _ in full])

    # mu_g: max_i || g^i - g ||
    mu_g = max(float(tree_diff_norm(full[i][0], pooled_gd)) for i in range(B))

    # sigma_g, sigma_h: E || minibatch grad - full grad ||, max over agents
    sg, sh = 0.0, 0.0
    for i, data in enumerate(agent_data):
        dev_g, dev_h = [], []
        for _ in range(n_var_samples):
            rng, r1, _ = prng.split(rng, 3)
            gd, gg = _grads(task, params, _sample_minibatch(data, r1, minibatch))
            dev_g.append(float(tree_diff_norm(gd, full[i][0])))
            dev_h.append(float(tree_diff_norm(gg, full[i][1])))
        sg = max(sg, sum(dev_g) / len(dev_g))
        sh = max(sh, sum(dev_h) / len(dev_h))

    # L: finite-difference Lipschitz estimate of the joint gradient field
    joint = {"disc": params["disc"], "gen": params["gen"]}
    leaves, treedef = tree_flatten(joint)
    flat = torch.cat([x.reshape(-1) for x in leaves])
    L = 0.0
    for _ in range(n_lip_samples):
        rng, r1, _ = prng.split(rng, 3)
        direction = np.random.default_rng([int(v) for v in r1]).standard_normal(flat.numel())
        direction = torch.from_numpy(direction.astype(np.float32)).to(flat.device)
        direction = direction / (torch.linalg.norm(direction) + 1e-12)
        moved = flat + lip_eps * direction
        parts, off = [], 0
        for x in leaves:
            parts.append(moved[off:off + x.numel()].reshape(x.shape))
            off += x.numel()
        p2 = {**params, **tree_unflatten(treedef, parts)}
        gd1, gg1 = _grads(task, params, agent_data[0])
        gd2, gg2 = _grads(task, p2, agent_data[0])
        dg = tree_diff_norm({"d": gd1, "g": gg1}, {"d": gd2, "g": gg2})
        L = max(L, float(dg) / lip_eps)

    return ConstantEstimates(L=max(L, 1e-6), sigma_g=sg, sigma_h=sh, mu_g=mu_g)


# ---------------------------------------------------------------------------
# Drift measurement: FedGAN vs the virtual centralized sequence (eq. 7)
# ---------------------------------------------------------------------------


def _sync(fed: FedGAN, state):
    """The eq. (2)+(3) sync of the reference's harness: the params (and,
    with ``average_opt_state``, the optimizer moments) averaged over the
    agents, the config's ``sync_dtype`` on the wire."""
    w = fed._w(state["step"].device)
    avg = lambda t: collectives.average_agents(t, w, sync_dtype=fed.cfg.sync_dtype)  # noqa: E731
    new = dict(state)
    new["params"] = avg(state["params"])
    if fed.cfg.average_opt_state:
        new["opt_g"], new["opt_d"] = avg(state["opt_g"]), avg(state["opt_d"])
    return new


def measure_drift(fed: FedGAN, state, agent_data: Sequence[Any], rng, *, n_steps: int,
                  minibatch: int = 64, pooled_grad_data: Sequence[Any] | None = None) -> dict:
    """Run ``n_steps`` of FedGAN (SGD) beside the virtual centralized
    sequence (v_n, phi_n) that takes the true pooled gradient, reset to the
    synced average at every multiple of K (eq. (7)).  ``rng`` is key data;
    agent i's minibatch at step n comes from ``fold_in`` of that step's
    key, as in the reference.

    Returns (n_steps,) float64 tensors: the agent drift (Lemma 1's left
    side, the max over agents), the average's drift (Lemma 2's) and the
    schedule a(n)."""
    cfg = fed.cfg
    P, A = cfg.agent_grid
    B = P * A
    K = cfg.sync_interval
    assert B == len(agent_data)
    pooled = pooled_grad_data if pooled_grad_data is not None else agent_data
    w = fed._w(state["step"].device).reshape(-1).tolist()
    strat = cfg.resolve_strategy()

    def pooled_grads(params):
        gs = [_grads(fed.task, params, d) for d in pooled]
        return _weighted_sum(w, [g for g, _ in gs]), _weighted_sum(w, [h for _, h in gs])

    virt = fed.averaged_params(state)
    agent_drift, avg_drift, lrs = [], [], []
    for n in range(n_steps):
        step_n = torch.tensor(float(n))
        lr_a, lr_b = float(fed.scales.a(step_n)), float(fed.scales.b(step_n))
        rng, rb, _ = prng.split(rng, 3)
        mbs = [_sample_minibatch(agent_data[i], prng.fold_in(rb, i), minibatch)
               for i in range(B)]
        batch = tree_map(lambda *xs: torch.stack(xs).reshape((P, A) + tuple(xs[0].shape)), *mbs)
        state, _ = fed._step(state, batch, strat)
        rng, _ = prng.split(rng)
        vgd, vgg = pooled_grads(virt)
        virt = {"disc": tree_map(lambda p, g: p - lr_a * g, virt["disc"], vgd),
                "gen": tree_map(lambda p, g: p - lr_b * g, virt["gen"], vgg)}
        if (n + 1) % K == 0:
            state = _sync(fed, state)
            virt = fed.averaged_params(state)   # v_n := w_n at the sync points
        drifts = []
        for p in range(P):
            for a in range(A):
                ap = fed.agent_params(state, p, a)
                drifts.append(float(tree_diff_norm(ap["disc"], virt["disc"])
                                    + tree_diff_norm(ap["gen"], virt["gen"])))
        agent_drift.append(max(drifts))
        avg = fed.averaged_params(state)
        avg_drift.append(float(tree_diff_norm(avg["disc"], virt["disc"])
                               + tree_diff_norm(avg["gen"], virt["gen"])))
        lrs.append(lr_a)
    as_t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    return {"agent_drift": as_t(agent_drift), "avg_drift": as_t(avg_drift), "lr": as_t(lrs)}
