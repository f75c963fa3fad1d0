"""Shared set-up of the port's tests: the image experiment's nets at 8x8
in both packages, the forward-and-gradient parity check of a module
against its JAX twin, one FedGAN round of each paper experiment (and of
the LM GAN at an arch's ``.smoke()`` config) at test size with the bounds
a round is held to, every sync kernel launch held to its plain version in
place (``held_sync_kernels``), attention split by query rows run rank by
rank (``attend_by_rows``), decode attention split by the cache's keys and
by head_dim slice by slice (``decode_by_slices``), the taught hold of a
K-step round step by step (``taught_mismatches``, ``held_step``) and the
first activation that flips in a free one (``free_flip``), and one torch thread
per test process (the tier-1 run puts several pytest workers on the same
cores, where torch's default of one thread per core oversubscribes
them).

The module imports JAX and the reference package only inside the helpers
that run them: ``test_torch_cuda.py`` and ``chip_smoke.py`` read the round
bounds on a machine without them.
"""
import contextlib
import dataclasses
import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.comm import IntQuant
from repro_torch.configs import paper_gans as tpaper
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import FedAvgSync, FedGAN, FedGANConfig, LocalOnly
from repro_torch.core.fedgan import _flat
from repro_torch.launch import train
from repro_torch.optim import SGD, Adam, constant, equal_timescale
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, GRID, BATCH, HW = 2, (1, 5), 8, 8
OPTS = {"sgd": (SGD, 0.05), "adam": (Adam, 1e-3)}


def _pair(opt, codec):
    from repro.comm import IntQuant as JQuant
    from repro.core.strategies import FedAvgSync as JSync
    return _strategy_pair(opt, JSync(codec=JQuant(8)) if codec else None,
                          FedAvgSync(codec=IntQuant(8)) if codec else None)


def _strategy_pair(opt, jstrategy, tstrategy, hw=HW, grid=GRID, k=K):
    """The same FedGAN in both packages, ACGAN nets at ``hw``, with the
    given sync strategies (None for the default)."""
    from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig
    from repro.launch.train import acgan_task as j_acgan_task
    from repro.optim import SGD as JSGD, Adam as JAdam, constant as jconst, \
        equal_timescale as jequal
    jopt = {"sgd": JSGD, "adam": JAdam}[opt]
    topt, lr = OPTS[opt]
    jtask, _ = j_acgan_task(hw=hw)
    ttask, _ = train.acgan_task(hw=hw)
    jfed = JFedGAN(jtask, JConfig(agent_grid=grid, sync_interval=k,
                                  strategy=jstrategy),
                   opt_g=jopt(), opt_d=jopt(), scales=jequal(jconst(lr)))
    tfed = FedGAN(ttask, FedGANConfig(agent_grid=grid, sync_interval=k,
                                      strategy=tstrategy),
                  opt_g=topt(), opt_d=topt(), scales=equal_timescale(constant(lr)))
    return jfed, tfed, lr


def coarsest_quanta(tfed, state, batches, qmax=127):
    """Per synced subtree, per leaf, the quantum of its coarsest block on
    either wire: max|v| / qmax over the agents' uplink values y = pre-sync
    params + EF residual (the same K steps without the sync, run by the
    port), with 1% for the float16 rounding of the scale."""
    pre = presync_params(tfed, state, batches)
    return {k: [1.01 * float((p + e).abs().max()) / qmax
                for p, e in zip(tree_leaves(pre[k]), tree_leaves(e_tree))]
            for k, e_tree in state["ef"].items()}


def presync_params(tfed, state, batches):
    """The agents' params after the round's K local steps, before its sync
    (the same steps under ``LocalOnly``, run by the port)."""
    local = dataclasses.replace(
        tfed, cfg=dataclasses.replace(tfed.cfg, strategy=LocalOnly()))
    return local.round(state, batches)[0]["params"]


def _batches(rng, grid=GRID, k=K):
    lead = (k,) + tuple(grid) + (BATCH,)
    return {"x": rng.uniform(-1, 1, lead + (HW, HW, 3)).astype(np.float32),
            "y": rng.integers(0, 10, lead).astype(np.int32),
            "z": rng.standard_normal(lead + (62,)).astype(np.float32)}


# a wire dtype's largest ulp relative to the value it rounds
_WIRE_REL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def assert_round_close(tfed, start, batches, got, want, opt, lr, codec, synced=True,
                       wire=None):
    """One round of the port (``got``, from ``start`` on ``batches``, trees
    of tensors) against the reference's (``want``, numpy) at ACGAN width:
    SGD within 1e-5 of each leaf's magnitude, Adam within 2·K·lr.  On at
    most 2% of the elements, two lossy wires may add to that:
    * an int8 ``codec``: one quantum of the leaf's coarsest block on the
      params and EF residuals (a value within roundoff of a rounding tie
      may take the neighbouring code);
    * a ``wire`` dtype (a ``sync_dtype``; SGD only): one wire ulp of the
      synced value, for the same reason.  Under ``FedAvgSync``: two wire
      ulps of the largest pre-sync agent value at the element (each agent's
      cast, its product and the mean's rounding may each take the
      neighbouring value).  Under ``PerStepGradAvg``
      it is each step's averaged gradient's, K·lr·``_WIRE_REL`` of the
      leaf's largest first-step gradient, on any share of the elements:
      the reference's per-step average runs compiled, where XLA's CPU
      backend keeps each product w_T·x in float32 instead of rounding it
      to the wire type as ``weighted_mean`` does op by op (and the port
      does), so the averaged gradients differ by one wire ulp on about a
      third of the elements (``test_torch_collectives.py``).  Both
      averages still land on the wire grid, so the params must agree bit
      for bit on at least half the elements (about 60% do; an average
      that skips the cast to the wire type leaves about 0.1%).
    With ``synced`` every agent must hold the same params."""
    import jax
    got = to_jax_params(got)
    K_ = tfed.cfg.sync_interval
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(want["step"])
    quanta = coarsest_quanta(tfed, start, batches) if codec else None
    quanta = quanta["disc"] + quanta["gen"] if codec else None
    if wire is not None and tfed.cfg.strategy.name == "distributed":
        grads = first_step_grads(tfed, start, batches)
        gmax = [float(g.abs().max()) for g in tree_leaves(grads["disc"])
                + tree_leaves(grads["gen"])]
    elif wire is not None:
        pre = presync_params(tfed, start, batches)
        xmax = [x.abs().amax((0, 1), keepdim=True).numpy()
                for x in tree_leaves(pre["disc"]) + tree_leaves(pre["gen"])]
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]  # noqa: E731
    if synced:
        for g in leaves(got["params"]):
            assert (g == g[:1, :1]).all()   # every agent holds the synced value
    over, differ, total = 0, 0, 0
    for key in ("params", "ef") if codec else ("params",):
        for i, (g, w) in enumerate(zip(leaves(got[key]), leaves(want[key]))):
            tol = (1e-5 * max(1.0, float(np.abs(w).max())) if opt == "sgd"
                   else 2 * K_ * lr)
            diff = np.abs(g - w)
            if codec:
                extra = max(quanta[i], 1.01 * float(np.abs(w).max()) / 127
                            if key == "params" else 0.0)
            elif wire is not None:
                extra = (K_ * lr * _WIRE_REL[wire] * gmax[i]
                         if tfed.cfg.strategy.name == "distributed"
                         else 2 * _WIRE_REL[wire] * xmax[i])
            else:
                extra = 0.0
            assert np.all(diff <= tol + extra), (key, i, float(diff.max()), tol)
            if wire is None or tfed.cfg.strategy.name != "distributed":
                over += int((diff > tol).sum())
            differ += int((diff > 0).sum())
            total += diff.size
    if wire is not None and tfed.cfg.strategy.name == "distributed":
        assert differ <= 0.5 * total, (differ, total)
    else:
        assert over <= 0.02 * max(total, 1), (over, total)


ATOL = 1e-5


def _close(got, want, atol=ATOL, rtol=0.0):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=rtol)


def _assert_tree_close(got, want, atol=ATOL, rtol=0.0):
    import jax
    got, want = to_jax_params(got), jax.device_get(want)
    jl, jt = jax.tree_util.tree_flatten(want)
    tl = jax.tree_util.tree_leaves(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        _close(t, j, atol=atol, rtol=rtol)


def _parity(jmod, tmod, inputs, *, seed=0):
    """Forward and gradient (of sum(out * r) wrt params and the float
    inputs) of a JAX module and its port on the same weights."""
    import jax
    import jax.numpy as jnp
    jparams = jmod.init(jax.random.key(seed))
    tparams = from_jax_params(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(seed + 1)
    jout = jax.jit(jmod.apply)(jparams, *[jnp.asarray(x) for x in inputs])
    touts = tmod.apply(tparams, *[torch.from_numpy(x) for x in inputs])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = touts if isinstance(touts, tuple) else (touts,)
    for t, j in zip(touts, jouts):
        _close(t.numpy(), j)
    rs = [rng.standard_normal(np.shape(j)).astype(np.float32) for j in jouts]

    def jloss(p, x0):
        o = jmod.apply(p, x0, *[jnp.asarray(x) for x in inputs[1:]])
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * r) for a, r in zip(o, rs))

    def tloss(p, x0):
        o = tmod.apply(p, x0, *[torch.from_numpy(x) for x in inputs[1:]])
        o = o if isinstance(o, tuple) else (o,)
        return sum(torch.sum(a * torch.from_numpy(r)) for a, r in zip(o, rs))

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jparams, jnp.asarray(inputs[0]))
    tg_p, tg_x = torch.func.grad(tloss, argnums=(0, 1))(
        tparams, torch.from_numpy(inputs[0]))
    _assert_tree_close(tg_p, jg_p)
    _close(tg_x.numpy(), jg_x)


# ---------------------------------------------------------------------------
# One FedGAN round of a paper experiment at test size, and its bounds
# ---------------------------------------------------------------------------

ROUND_K, ROUND_BATCH = 2, 16
# name: (the port's task, the float inputs' shapes beyond (K, P, A, b), the
# labels): None, ("onehot", n) (drawn after the floats, replacing the float
# "y" the layout lists) or ("index", n), integer classes.  ACGAN nets at 8x8.
ROUND_TASKS = {
    "toy_2d": (train.toy2d_task, {"x": (), "z": ()}, None),
    "mixed_gaussian": (train.mlp_gan_task, {"x": (2,), "z": (2,)}, None),
    "swiss_roll": (train.mlp_gan_task, {"x": (2,), "z": (2,)}, None),
    "image_acgan": (functools.partial(train.acgan_task, hw=8),
                    {"x": (8, 8, 3), "z": (62,)}, ("index", 10)),
    "celeba_acgan": (functools.partial(train.acgan_task, hw=8, num_classes=16),
                     {"x": (8, 8, 3), "z": (62,)}, ("index", 16)),
    "timeseries_cgan": (train.cgan1d_task, {"x": (24,), "z": (24,), "y": (5,)},
                        ("onehot", 5)),
}


def round_inputs(name, K=ROUND_K, b=ROUND_BATCH):
    """(agent grid, numpy batches with leading (K, P, A, b)) of one round
    of ``name``, from numpy's generator seeded 0."""
    _, layout, labels = ROUND_TASKS[name]
    grid = (1, tpaper.ALL_EXPERIMENTS[name].num_agents)
    rng = np.random.default_rng(0)
    lead = (K,) + grid + (b,)
    batches = {k: rng.standard_normal(lead + s).astype(np.float32)
               for k, s in layout.items()}
    if labels is not None:
        kind, n = labels
        y = rng.integers(0, n, lead)
        batches["y"] = (np.eye(n, dtype=np.float32)[y] if kind == "onehot"
                        else y.astype(np.int32))
    return grid, batches


def round_fed(name, K=ROUND_K, *, opts=None, scales=None, strategy=None, dp=None):
    """The port's FedGAN of ``name`` at test size: its task from
    ``ROUND_TASKS``, the experiment's optimizers and schedules unless
    given, ``strategy`` and ``dp`` in its config."""
    exp = tpaper.ALL_EXPERIMENTS[name]
    opt_d, opt_g = opts or tpaper.optimizer_for(exp)
    cfg = FedGANConfig(agent_grid=(1, exp.num_agents), sync_interval=K, strategy=strategy,
                       dp=dp)
    return FedGAN(ROUND_TASKS[name][0]()[0], cfg, opt_d=opt_d, opt_g=opt_g,
                  scales=scales or tpaper.scales_for(exp))


# The bounds one round is held to, elementwise, against the reference (the
# JAX package) and on the card against the CPU port.  SGD: _SGD of the
# leaf's largest magnitude above 1.  Adam: _ULPS float32 ulps of max(|p|,
# K lr) plus _TIGHT K lr for the gradients' float32 rounding as Adam
# carries it through the K steps, with the lr of the net the leaf belongs
# to (TTUR gives D and G their own).  Where some agent's first-step
# gradient in the reference is not 0 but within _ZERO_TO_ROUNDING of its
# leaf's largest magnitude, the gradient is zero to rounding: Adam scales
# it to a step of up to lr, so its rounding reaches the parameter.  There
# the bound is _LOOSE K lr, and the set is held to _ZERO_SHARE of its leaf.
# The first step's losses (the same weights and batch) within _LOSS_RTOL.
#
# Batch norm adds one case.  A bias that feeds a batch norm does not move
# the loss (the norm subtracts it again), so its gradient is rounding noise
# on every agent: the whole leaf is within _ZERO_TO_ROUNDING of its net's
# largest first-step gradient.  Adam steps each element by about lr with
# the noise's sign, which two correct implementations do not share: the
# reference against itself, on the same batch in another order, departs
# there by more than 0.1 K lr (test_torch_paper.py's
# test_round_bounds_hold_the_reference_to_itself).  Such a leaf is held to
# _REACH K lr, the reach of K steps of at most lr each way, and the bound
# test_torch_round.py holds the whole image round to.  Those steps shift
# the rounding of the net's later sums, so in a net that has such a leaf,
# a second-step gradient elsewhere may be noise too: at most _STRAY_SHARE
# of each other leaf may leave the Adam bound, and no further than _REACH
# K lr (the reference against itself needs a few elements in a million).
# A net without such a leaf (every net but the ACGAN's) keeps the Adam
# bound on every element.
_SGD = 1e-5
_ULPS, _TIGHT = 4, 2e-4
_ZERO_TO_ROUNDING, _LOOSE, _ZERO_SHARE = 1e-5, 1e-2, 0.2
_REACH, _STRAY_SHARE = 2.0, 1e-3
_LOSS_RTOL = 1e-5


def named_leaves(tree, path=""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in
    ``tree_leaves``' order (dict keys sorted, as the reference's)."""
    join = (lambda k: f"{path}/{k}") if path else str  # noqa: E731
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in named_leaves(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree) for pl in named_leaves(x, join(i))]
    return [] if tree is None else [(path, tree)]


def noise_leaves(grads, net):
    """The leaves of ``net`` whose first-step gradient is rounding noise on
    every agent: within _ZERO_TO_ROUNDING of the net's largest."""
    leaves = named_leaves(grads[net], net)
    top = max(float(np.abs(g).max()) for _, g in leaves if g.size)
    return {p for p, g in leaves if float(np.abs(g).max()) <= _ZERO_TO_ROUNDING * top}


def round_mismatches(exp, K, got, want, grads, losses, synced=True, step=None):
    """Every way the round ``got`` departs from ``want`` under the bounds
    above, and the worst leaf.  ``got``, ``want``: the states after the
    round as trees of numpy arrays (``params`` leaves (P, A, ...),
    ``step``); ``grads``: ``{"disc", "gen"}`` trees of each agent's
    first-step gradients on the ``want`` side, (B, ...) numpy; ``losses``:
    ((d_loss, g_loss) of ``got``'s first step, the same of ``want``'s).
    Returns (departures, (ratio, path)): an empty list when the round is
    within its bounds, and the largest ratio of |got - want| to its limit
    with the leaf where it sits.  ``synced=False`` drops the check that
    every agent holds the same params (a fleet round whose faulted slots
    keep their own).  ``step``: the step counter ``got`` must hold, K
    unless given (a taught step k holds k at one step's bounds)."""
    bad, worst = [], (-1.0, None)
    for k, g, w in zip(("d_loss", "g_loss"), *losses):
        if not np.isclose(g, w, rtol=_LOSS_RTOL, atol=0):
            bad.append((k, g, w))
    if int(got["step"]) != (K if step is None else step):
        bad.append(("step", int(got["step"])))
    for net in ("disc", "gen"):
        lr = exp.lr_d if net == "disc" else exp.lr_g
        gl, wl, rl = (named_leaves(t[net], net) for t in (got["params"], want["params"], grads))
        assert [p for p, _ in gl] == [p for p, _ in wl] == [p for p, _ in rl]
        noise = noise_leaves(grads, net) if exp.opt == "adam" else set()
        for (path, g), (_, w), (_, gr) in zip(gl, wl, rl):
            if synced and not (g == g[:1, :1]).all():
                bad.append((path, "agents not synced"))
            d = np.abs(g - w)
            if exp.opt == "sgd":
                lim = np.full(d.shape, _SGD * max(1.0, float(np.abs(w).max())))
            else:
                ulps = _ULPS * np.spacing(np.maximum(np.abs(w), np.float32(K * lr)))
                reach = ulps + _REACH * K * lr
                mag = np.abs(gr).reshape((-1,) + w.shape[2:])
                zero = ((mag > 0) & (mag <= _ZERO_TO_ROUNDING * mag.max())).any(0)
                lim = ulps + K * lr * np.where(zero, _LOOSE, _TIGHT)
                if path in noise:
                    lim = reach
                elif zero.sum() > _ZERO_SHARE * zero.size:
                    bad.append((path, "zero to rounding", int(zero.sum()), zero.size))
                if noise and path not in noise:
                    stray = d > lim
                    if stray.sum() <= _STRAY_SHARE * d.size:
                        lim = np.where(stray, reach, lim)
            ratio = float((d / lim).max()) if d.size else 0.0
            worst = max(worst, (ratio, path), key=lambda r: r[0])
            if (d > lim).any():
                bad.append((path, "off", int((d > lim).sum()), float((d - lim).max())))
    return bad, worst


def first_step_grads(fed, state, batches):
    """Each agent's first-step (disc, gen) gradients at ``state``, (B, ...)
    leaves, as the round's first local step takes them (under a clip-only
    ``dp``, the clipped per-example means)."""
    B = fed.cfg.num_agents
    gd, gg, _ = fed._grads(_flat(state["params"], B),
                           _flat(tree_map(lambda x: x[0], batches), B), None)
    return {"disc": gd, "gen": gg}


# The card's round is held to the CPU port's at K = 1.  At K = 2 the second
# step amplifies a discrete event: an activation whose input sits at
# rounding distance from its kink changes sign on one agent, and that
# agent's second Adam step moves by up to about lr.  The CPU port against
# itself on a reordered batch departs so in image_acgan (over 100 times
# its bounds, test_torch_paper.py's
# test_second_step_amplifies_a_flip_so_the_card_round_takes_one; a
# leaky-ReLU input of the discriminator changes sign on some agents).  One
# step holds the forward and backward (cuDNN on the card), Adam and the
# sync to the bounds with nothing to amplify.
CARD_K = 1


def port_round_mismatches(name, device, K=CARD_K, order=None, strategy=None, dp=None):
    """One round of ``name`` (``round_fed``, with ``strategy`` and a
    clip-only ``dp`` when given) on ``device`` against the same round on
    the CPU port, from one start state (drawn on the CPU from a seeded
    generator, then copied) and the numpy batches of ``round_inputs``:
    ``round_mismatches`` with the CPU round in the reference's place.  With
    ``order`` (a seed), the ``device`` round takes each agent's samples in
    another order.  The CPU runs with oneDNN off, as the round is held to
    the reference: its convolution backward under the agent vmap is not
    exact float32."""
    fed = round_fed(name, K, strategy=strategy, dp=dp)
    _, batches = round_inputs(name, K)
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    to_dev = lambda t: tree_map(lambda x: torch.from_numpy(x).to(device), t)  # noqa: E731
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        want, wm = fed.round(start, tree_map(torch.from_numpy, batches))
        grads = first_step_grads(fed, start, tree_map(torch.from_numpy, batches))
        if order is not None:
            perm = np.random.default_rng(order).permutation(ROUND_BATCH)
            batches = {k: np.ascontiguousarray(v[:, :, :, perm]) for k, v in batches.items()}
        got, gm = fed.round(tree_map(lambda x: x.to(device), start), to_dev(batches))
    to_np = lambda t: tree_map(lambda x: x.detach().cpu().numpy(), t)  # noqa: E731
    losses = tuple((m["d_loss"][0].item(), m["g_loss"][0].item()) for m in (gm, wm))
    return round_mismatches(tpaper.ALL_EXPERIMENTS[name], K, to_np(got), to_np(want),
                            to_np(grads), losses)


# ---------------------------------------------------------------------------
# The taught hold of a K-step round, step by step
# ---------------------------------------------------------------------------

# A free round amplifies from step 2 on what step 1 rounded differently
# (``CARD_K``).  A taught round leaves nothing to amplify: the side under
# test runs each step k, and the sync, from the checker's own state before
# it, and each result is held to the checker's.  Step k is held by
# ``round_mismatches`` at one step's bounds (K = 1, the checker's
# gradients of that step, agents not required to agree; ``held_step``);
# the sync by ``sync_mismatches``.  A correct K-step round passes every
# step; a fault that shows only from step 2 on (Adam's moments reset, its
# bias correction frozen, a rate read at n = 0) fails some step k >= 2.


def port_steps(fed, start, batches):
    """The round of ``fed`` on the port, step by step, on the device of
    ``start``, as ``FedGAN.round`` runs it (``batches``: tensors with
    leading (K, P, A)): (the K + 1 states before each step and after the
    last, each step's metrics, the synced state, each step's (P, A, ...)
    gradients as the strategy's ``grad_hook`` receives them).  Strategies
    without a segment sync."""
    strat = fed.cfg.resolve_strategy()
    assert not strat.intra_interval
    states, metrics, grads = [start], [], []
    for k in range(fed.cfg.sync_interval):
        seen = _SeenGrads(strat)
        state, m = fed._step(states[-1], tree_map(lambda x: x[k], batches), seen)
        states.append(state)
        metrics.append(m)
        grads.append(seen.grads)
    return states, metrics, strat.round_sync(fed, states[-1]), grads


def _np(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _float_bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


class _SeenGrads:
    """A strategy for one ``FedGAN._step`` that keeps the (P, A)-stacked
    gradients its ``grad_hook`` receives."""

    def __init__(self, strat):
        self.strat, self.grads = strat, None

    def grad_hook(self, fed, gd, gg, state):
        self.grads = {"disc": gd, "gen": gg}
        return self.strat.grad_hook(fed, gd, gg, state)


class _TaughtGrads(_SeenGrads):
    """A strategy for one ``FedGAN._step`` whose ``grad_hook`` receives the
    checker's gradients ``taught`` in place of the step's own where
    ``mask`` is set (both (P, A, ...) trees ``{"disc", "gen"}``, the mask
    fixed before the step)."""

    def __init__(self, strat, taught, mask):
        super().__init__(strat)
        self.taught, self.mask = taught, mask

    def grad_hook(self, fed, gd, gg, state):
        super().grad_hook(fed, gd, gg, state)
        gd, gg = (tree_map(torch.where, self.mask[k], self.taught[k], g)
                  for k, g in (("disc", gd), ("gen", gg)))
        return self.strat.grad_hook(fed, gd, gg, state)


# A taught step can still meet one discrete event inside itself: an
# activation input that the two sides compute at rounding distance from
# its kink, on opposite sides of it.  Its gradient then takes the other
# branch on one side, a batch norm spreads that over the channel, and Adam
# past its first step scales the change to a good part of lr (against the
# reference, image_acgan's step 2 departs 9,322x, timeseries_cgan's step 3
# 2,133x; the port's step 2 on the card may meet one as well).  Where a
# taught step departs, the kinks are taught too: every ReLU and leaky ReLU
# input where the two sides take opposite branches and both values lie
# within _KINK_ROUNDING times its own rounding scale (float32's unit
# roundoff times the ``_Rounding`` bound, the side under test's) takes the
# checker's branch on the side under test, and the step is run again and
# held to the same bounds.  A flip farther from the kink is never taught:
# the step departs.  The port's activation inputs differ from the
# reference's by at most 1.9 times that scale at the CPU's taught steps
# (``python tests/test_torch_steps.py``), the card's from the CPU's by at
# most 1.24 (the ``spread`` that ``chip_smoke.py`` prints); deep in a net
# the scale is loose, a few hundred times the differences seen there.
_UNIT = 2.0 ** -24
_KINK_ROUNDING = 8.0

_OPEN = []


def _plain(x):
    """``x``'s value outside torch.func's wrappers, a vmapped tensor's
    batch dim first."""
    F = torch._C._functorch
    while F.is_functorch_wrapped_tensor(x):
        if F.is_batchedtensor(x):
            x = F.get_unwrapped(x).movedim(F.maybe_get_bdim(x), 0)
        else:
            x = F.get_unwrapped(x)
    return x.detach().clone()


def _abs(x):
    return x.abs() if isinstance(x, torch.Tensor) else abs(x)


class _Rounding(torch.overrides.TorchFunctionMode):
    """While active, every tensor that the nets compute from a dot product
    (a matmul or a convolution) carries a scale of its float32 rounding, in
    units of the unit roundoff, grown op by op to first order: a dot
    product of n terms adds sqrt(n) sum |w a| of its own (the
    probabilistic bound of its n roundings) and carries its inputs' scales
    S through w in quadrature, sqrt(sum w^2 S^2) (their roundings
    independent); sums, means and reshapes carry theirs; products and the
    elementwise functions scale them by their slopes.  An op without a
    rule drops the scale (what follows counts its input as exact).
    ``bound(t)``: ``t``'s, or None."""

    _SHAPE = {"permute", "reshape", "flip", "expand", "__getitem__", "detach", "to", "float",
              "pad"}

    def __init__(self):
        super().__init__()
        self.bounds = {}

    def bound(self, t):
        kept = self.bounds.get(id(t))
        return kept[1] if kept is not None and kept[0] is t else None

    def _rule(self, name, out, args, kw):
        S = [self.bound(a) if isinstance(a, torch.Tensor) else None for a in args]
        if name in ("matmul", "conv1d", "conv2d", "conv_transpose2d"):
            rest = tuple(None if isinstance(r, torch.Tensor) else r for r in args[2:])
            kw = {k: v for k, v in kw.items() if k != "bias"}
            dot, (a, w) = getattr(torch, name), args[:2]
            n = w.shape[-2] if name == "matmul" else w[0].numel() if name != "conv_transpose2d" \
                else w.numel() // w.shape[1]
            own = dot(a.abs(), w.abs(), *rest, **kw) * n ** 0.5
            if S[0] is None:
                return own
            return own + torch.sqrt(dot(S[0] * S[0], w * w, *rest, **kw))
        if name == "cat":
            parts = [self.bound(t) for t in args[0]]
            if all(p is None for p in parts):
                return None
            return torch.cat([torch.zeros_like(t) if p is None else p
                              for t, p in zip(args[0], parts)], *args[1:], **kw)
        if S[0] is None and not any(s is not None for s in S[1:]):
            return None
        zero = lambda i: torch.zeros_like(out) if S[i] is None else S[i]  # noqa: E731
        if name in self._SHAPE:
            return getattr(torch.nn.functional, name)(S[0], *args[1:], **kw) \
                if name == "pad" else getattr(S[0], name)(*args[1:], **kw)
        if name in ("add", "sub", "__rsub__"):
            return torch.broadcast_to(zero(0) + (zero(1) if len(S) > 1 else 0), out.shape)
        if name == "neg":
            return S[0]
        if name == "mul":
            return (zero(0) * _abs(args[1]) + (_abs(args[0]) * zero(1) if len(S) > 1 else 0))
        if name == "div":
            return (zero(0) + out.abs() * (zero(1) if len(S) > 1 else 0)) / _abs(args[1])
        if name == "mean":
            return torch.mean(S[0] + args[0].abs(), *args[1:], **kw)
        if name == "square":
            return 2 * args[0].abs() * S[0]
        if name == "rsqrt":
            return 0.5 * out.abs() ** 3 * S[0]
        if name == "tanh":
            return (1 - out * out) * S[0]
        if name == "relu":
            return torch.where(out > 0, S[0], 0)
        if name == "where":
            return torch.where(args[0], zero(1), zero(2))
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            s = self._rule(getattr(func, "__name__", ""), out, args, kwargs)
            if s is not None:
                self.bounds[id(out)] = (out, s)
        return out


class _Kinks:
    """The open ``kink_context``: each call's (kind, input, rounding bound
    or None) in call order, the (mask, branch) pairs still to teach, one a
    call (``queue``, or None), the rounding mode when it bounds, and each
    call's site (``_site``)."""

    def __init__(self, rounding):
        self.records, self.queue, self.rounding, self.sites = [], None, rounding, []


def _site():
    """The source line of the port's nets that called an activation."""
    frame = sys._getframe(2)
    while frame is not None and "models" not in frame.f_code.co_filename:
        frame = frame.f_back
    return None if frame is None else \
        f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


def _kinked(kind, fn, slope=0.0):
    def act(x):
        ctx = _OPEN[-1] if _OPEN else None
        if ctx is None:
            return fn(x)
        s = None if ctx.rounding is None else ctx.rounding.bound(x)
        ctx.records.append((kind, _plain(x), None if s is None else _plain(s)))
        ctx.sites.append(_site())
        if not ctx.queue:
            return fn(x)
        mask, branch = ctx.queue.pop(0)
        low = slope * x if slope else torch.zeros_like(x)
        return torch.where(mask, torch.where(branch, x, low), fn(x))
    return act


@contextlib.contextmanager
def kink_context(bounds=False):
    """While open, every ReLU (``torch.relu``) and leaky ReLU
    (``repro_torch.nn.leaky_relu``) of the port's nets records its input
    (``(kind, value, rounding bound)`` in the yielded context's
    ``records``, the bound ``_Rounding``'s where ``bounds``, else None),
    and, while its ``queue`` is set, the masked elements of each call take
    the branch given (True: the x >= 0 side of a leaky ReLU, x > 0 of a
    ReLU)."""
    from repro_torch import nn as tnn
    relu, leaky = torch.relu, tnn.leaky_relu
    ctx = _Kinks(_Rounding() if bounds else None)
    torch.relu = _kinked("relu", relu)
    tnn.leaky_relu = lambda slope=0.2: _kinked("leaky_relu", leaky(slope), slope)
    _OPEN.append(ctx)
    try:
        with ctx.rounding or contextlib.nullcontext():
            yield ctx
    finally:
        _OPEN.pop()
        torch.relu, tnn.leaky_relu = relu, leaky


_TEACH = "kinks to teach"


def _teaching(loss, ctx, first):
    """``loss`` handing its batch's ``_TEACH`` entry, per agent as the
    step's vmap slices it, to ``ctx``'s queue (``first``: the disc loss,
    which the agent's gradients run first)."""
    def run(params, batch):
        batch = dict(batch)
        masks = batch.pop(_TEACH)
        if first:
            ctx.queue = list(masks)
        return loss(params, batch)
    return run


def kinked_step(fed, state, batch, teach=None, strat=None, bounds=False):
    """``fed._step`` on (P, A, ...) ``batch`` inside ``kink_context``
    (``bounds``: with the rounding bounds), ``teach`` (per call a (mask,
    branch) pair of (B, ...) bool tensors, or None) applied: the pairs
    ride in the batch, so the step's own agent vmap hands each agent its
    own, and the losses put them in the queue.  ``strat`` in place of the
    config's strategy when given.  Returns (state, metrics, records)."""
    with kink_context(bounds) as ctx:
        if teach is not None:
            task = fed.task
            fed = dataclasses.replace(fed, task=dataclasses.replace(
                task, disc_loss=_teaching(task.disc_loss, ctx, True),
                gen_loss=_teaching(task.gen_loss, ctx, False)))
            lead = tree_leaves(state["params"])[0].shape[:2]
            batch = {**batch, _TEACH: [tuple(t.reshape(lead + t.shape[1:]) for t in pair)
                                       for pair in teach]}
        out, m = fed._step(state, batch, strat or fed.cfg.resolve_strategy())
    return out, m, ctx.records


def _branch(kind, x):
    return x >= 0 if kind == "leaky_relu" else x > 0


def kink_flips(test, checker):
    """The activation inputs on which ``test`` and ``checker`` (records of
    one step, (kind, (B, ...) input, bound) per call, the bounds the test
    side's) take opposite branches: per call (mask of those within
    rounding of the kink: both values within _KINK_ROUNDING times the
    test side's rounding bound, in unit roundoffs; the checker's branch),
    the count of the others (farther from the kink), the first flip in
    call order as (call, kind, agent, index, test value, checker value,
    its rounding scale: unit roundoff times the bound) or None, and the
    largest |test - checker| over its rounding scale on any element (how
    much of the window rounding takes)."""
    teach, far, first, spread = [], 0, None, 0.0
    assert [k for k, *_ in test] == [k for k, *_ in checker]
    for c, ((kind, t, s), (_, w, _)) in enumerate(zip(test, checker)):
        w = w.to(t.device)
        assert t.shape == w.shape, (c, t.shape, w.shape)
        pos = _branch(kind, w)
        flip = _branch(kind, t) != pos
        scale = torch.zeros_like(t) if s is None else _UNIT * s
        near = flip & (torch.maximum(t.abs(), w.abs()) <= _KINK_ROUNDING * scale)
        far += int((flip & ~near).sum())
        if s is not None:
            spread = max(spread, float(((t - w).abs() / scale).nan_to_num(0.0).max()))
        if first is None and bool(flip.any()):
            idx = tuple(int(i) for i in flip.nonzero()[0])
            first = (c, kind, idx[0], idx[1:], float(t[idx]), float(w[idx]), float(scale[idx]))
        teach.append((near, pos))
    return teach, far, first, spread


def taught_step(fed, state, batch, checker_records, hold, tries=4):
    """Step k of a taught round whose plain hold departed, again with the
    kinks taught (the block comment above): the side under test records its
    activation inputs with their rounding bounds (those of its untaught
    run) and takes the checker's
    branch wherever both lie within rounding of the kink on opposite
    sides, run again until no new such flip appears (at most ``tries``
    runs).  ``hold(got, metrics)`` holds a result.  Returns (hold's result,
    kinks taught, flips farther from the kink, the first flip and the
    spread of the untaught step (``kink_flips``), the last run's
    ``teach``)."""
    teach, taught, first0, spread0 = None, 0, None, None
    for i in range(tries):
        got, m, records = kinked_step(fed, state, batch, teach, bounds=i == 0)
        if i == 0:
            scales = [s for _, _, s in records]
        else:   # the untaught run's scales
            records = [(kind, x, s) for (kind, x, _), s in zip(records, scales)]
        near, far, first, spread = kink_flips(records, checker_records)
        if i == 0:
            first0, spread0 = first, spread
        if teach is not None:   # a taught input keeps its own sign: still listed
            near = [(a | b, torch.where(a, pa, pb)) for (a, pa), (b, pb) in zip(teach, near)]
        n = sum(int(mk.sum()) for mk, _ in near)
        if n == taught:
            break
        teach, taught = near, n
    return hold(got, m), taught, far, first0, spread0, teach


# Adam's first update lr g / (|g| + eps) has the slope lr eps / (|g| +
# eps)^2 in g: at |g| within a hundred eps or so of 0 it turns a rounding
# difference of the gradient alone into more than the tight bound of the
# round bounds, before any moment could damp it.  The reference against
# itself departs so at timeseries_cgan's first step on the K = 4 batches
# (9.9-20.8x on disc/conv/14/b, at a gradient of 94.6 eps:
# test_torch_steps.py).  Where a step at Adam's count 0 still departs, the
# gradient elements whose checker's value lies within _EPS_ZONE eps of 0
# take the checker's value: a set fixed by the checker's gradients and
# this constant alone, before the step, and never past count 0.
_EPS_ZONE = 128


def eps_zone(fed, before, grads):
    """The gradient elements to teach (``_EPS_ZONE`` above) as bool
    (P, A, ...) trees ``{"disc", "gen"}`` beside the checker's ``grads``,
    or None: where either net's optimizer is not Adam, or the step is not
    its first (``before``'s counts not all 0)."""
    opts = {"disc": (fed.opt_d, before["opt_d"]), "gen": (fed.opt_g, before["opt_g"])}
    if not all(isinstance(o, Adam) and int(s["count"].max()) == 0 for o, s in opts.values()):
        return None
    return {net: tree_map(lambda g: g.abs() <= _EPS_ZONE * opts[net][0].eps, grads[net])
            for net in ("disc", "gen")}


def held_step(fed, before, batch, want, metrics, hold_step, k, grads=None, kinks=None):
    """One taught step: ``FedGAN._step`` from ``before`` on the (P, A, ...)
    ``batch`` (both on the device under test), held to the checker's
    result ``want`` (numpy) and ``metrics`` by ``hold_step(k, got, want,
    grads, losses)``, with ``grads`` the checker's gradients in that step
    ((P, A, ...) torch tree on the CPU), else the step's own as its
    ``grad_hook`` receives them.

    A step that departs is run again with more of the checker taught, and
    held again to the same bounds:
    1. its kinks, where ``kinks()`` gives the checker's activation inputs
       in that step (``taught_step``); a flip farther from the kink than
       rounding is a departure;
    2. then, where ``grads`` is given and the step is Adam's first, the
       gradient elements of ``eps_zone`` take the checker's value (its set
       is the checker's alone, so a larger fault does not grow it).  Every
       other gradient element stays the step's own, and every update is
       the side's own, so a fault of the optimizer, its state or its
       rates, or of the forward or the backward beyond those elements,
       still departs.
    Returns (departures, (ratio, leaf), how): ``how`` None where the step
    held untaught, else {"untaught": its (ratio, leaf, departures),
    "taught": kinks taught, "far": flips farther from the kink, "first":
    the first flip and "spread" the largest |difference| over its rounding
    scale of any activation input (``kink_flips``), "zone": gradient
    elements taught (where that tier ran)}."""
    strat = fed.cfg.resolve_strategy()
    seen = _SeenGrads(strat)
    out = fed._step(before, batch, seen)
    mask_grads = _np(seen.grads if grads is None else grads)

    def hold(got, gm):
        losses = tuple((float(m["d_loss"]), float(m["g_loss"])) for m in (gm, metrics))
        return hold_step(k, _np(got), want, mask_grads, losses)

    bad, worst = hold(*out)
    if not bad:
        return bad, worst, None
    how = {"untaught": (worst[0], worst[1], len(bad)), "taught": 0, "far": 0, "first": None,
           "spread": None}
    teach = None
    if kinks is not None:
        (bad, worst), how["taught"], how["far"], how["first"], how["spread"], teach = \
            taught_step(fed, before, batch, kinks(), hold)
    zone = None if grads is None else eps_zone(fed, before, grads)
    if bad and zone is not None:
        dev = tree_leaves(before["params"])[0].device
        taught = _TaughtGrads(strat, tree_map(lambda x: x.to(dev), grads),
                              tree_map(lambda x: x.to(dev), zone))
        got, m, _ = kinked_step(fed, before, batch, teach, taught)
        bad, worst = hold(got, m)
        how["zone"] = sum(int(z.sum()) for z in tree_leaves(zone))
    if how["far"]:
        bad.append(("kinks", "flips farther than rounding", how["far"], how["first"]))
    return bad, worst, how


def sync_mismatches(got, want, coded=False):
    """The sync ``got`` (``round_sync`` on the checker's state before it)
    against the checker's ``want``, whole states as trees of numpy arrays.
    The plain average: every leaf bit for bit.  A coded sync (int8), as
    ``chip_smoke.py``'s small round holds it: the params, the EF residuals
    and the downlink residual within 1e-4 of the matching params leaf's
    magnitude m, and on at most 2% of their elements within 1.5 m / 127
    more (a value at a rounding tie may take the neighbouring code: one
    quantum of the leaf's coarsest block, on an uplink flip 1/B of an
    agent's on top); every other leaf bit for bit.  Returns (departures,
    (largest ratio of a difference to its limit, its leaf), elements that
    differ at all)."""
    bad, worst, differ, over, total = [], (0.0, None), 0, 0, 0
    mags = {p.split("/", 1)[1]: max(1.0, float(np.abs(w).max()))
            for p, w in named_leaves(want["params"], "params")}
    for (path, g), (wpath, w) in zip(named_leaves(got), named_leaves(want)):
        assert path == wpath
        g, w = np.asarray(g), np.asarray(w)
        same = _float_bits(g) == _float_bits(w)
        differ += int((~same).sum())
        top, _, rest = path.partition("/")
        if not (coded and top in ("params", "ef", "ef_down")):
            if not same.all():
                bad.append((path, "not bit for bit", int((~same).sum())))
                worst = max(worst, (float("inf"), path), key=lambda r: r[0])
            continue
        mag = mags[rest]
        d = np.abs(g - w)
        tol = 1e-4 * mag
        lim = tol + 1.5 * mag / 127
        over += int((d > tol).sum())
        total += d.size
        if (d > lim).any():
            bad.append((path, "off", int((d > lim).sum()), float(d.max())))
        ratio = float(d.max()) / lim if d.size else 0.0
        worst = max(worst, (ratio, path), key=lambda r: r[0])
    if over > 0.02 * max(total, 1):
        bad.append(("codes", "moved past 1e-4", over, total))
    return bad, worst, differ


def taught_mismatches(fed, checker, batches, device, hold_step, coded=False, kinks=None,
                      upto=None):
    """The taught round of ``fed``: for k = 1..K, one ``held_step`` on
    ``device`` from the checker's whole state before step k (params,
    ``opt_d``, ``opt_g``, ``step`` and what the strategy carries, such as
    EF residuals), held to the checker's step k; then the strategy's
    ``round_sync`` on ``device`` from the checker's state before its sync,
    held by ``sync_mismatches``.  ``checker``: ``port_steps``' (states,
    metrics, synced, gradients) as CPU torch trees, from whichever package;
    ``batches``: numpy (K, P, A, ...).  ``kinks(k)``,
    when given, returns the checker's activation inputs on step k
    (``kinked_step``'s records).  ``upto``: the last step to run (all K
    unless given; with it, no sync).  Runs with oneDNN off, as every round
    held to the reference.  Returns ([``held_step``'s result for each
    step], ``sync_mismatches``')."""
    states, metrics, synced, grads = checker
    strat = fed.cfg.resolve_strategy()
    to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    steps = []
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        for k in range(1, (upto or fed.cfg.sync_interval) + 1):
            batch = tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x[k - 1])), batches)
            of = None if kinks is None else functools.partial(kinks, k)
            steps.append(held_step(fed, to_dev(states[k - 1]), to_dev(batch),
                                   _np(states[k]), metrics[k - 1], hold_step, k,
                                   grads=grads[k - 1], kinks=of))
        if upto is not None:
            return steps, None
        got = strat.round_sync(fed, to_dev(states[-1]))
    return steps, sync_mismatches(_np(got), _np(synced), coded)


def port_kinks(fed, states, batches):
    """``taught_mismatches``' ``kinks`` with the CPU port as the checker:
    its activation inputs at ``states[k - 1]`` on step k's batch."""
    def of(k):
        batch = tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x[k - 1])), batches)
        with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
            return kinked_step(fed, states[k - 1], batch)[2]
    return of


def paper_step_hold(exp):
    """``held_step``'s ``hold_step`` for a paper experiment:
    ``round_mismatches`` at one step's bounds, the step counter the
    checker's."""
    return lambda k, got, want, grads, losses: round_mismatches(
        exp, 1, got, want, grads, losses, synced=False, step=int(want["step"]))


def port_taught_mismatches(name, device, K, strategy=None):
    """``taught_mismatches`` of ``name``'s round at test size
    (``round_fed`` with ``strategy``, ``round_inputs``) on ``device``
    against the CPU port's steps from one start state, drawn on the CPU
    from a seeded generator.  The free round's ratio stays beside it in
    ``port_round_mismatches``."""
    fed = round_fed(name, K, strategy=strategy)
    batches = round_inputs(name, K)[1]
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        checker = port_steps(fed, start, tree_map(torch.from_numpy, batches))
    coded = getattr(fed.cfg.resolve_strategy(), "codec", None) is not None
    return taught_mismatches(fed, checker, batches, device,
                             paper_step_hold(tpaper.ALL_EXPERIMENTS[name]), coded,
                             kinks=port_kinks(fed, checker[0], batches))


def free_flip(name, device, order=None):
    """The first activation that flips in a free K = 2 round of ``name``
    at test size on ``device`` against the CPU port: both sides run step 1
    from one start state, then each side's step-2 activation inputs at its
    own state (``kinked_step``'s records, the device's with its rounding
    bounds) are compared in call order.  With ``order`` (a seed) the side
    on ``device`` takes each agent's samples in another order (its records
    are put back in the CPU's order).  Returns None, or {"call", "kind",
    "site" (the net's source line that called it), "agent", "index",
    "test", "checker" (the two float32 inputs), "scale" (unit roundoff
    times the device side's rounding bound there), "near" and "far" (the
    step-2 flips within _KINK_ROUNDING of their scale and farther)}."""
    fed = round_fed(name, 2)
    batches = tree_map(torch.from_numpy, round_inputs(name, 2)[1])
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    strat = fed.cfg.resolve_strategy()
    perm = torch.arange(ROUND_BATCH) if order is None else torch.from_numpy(
        np.random.default_rng(order).permutation(ROUND_BATCH))
    step_of = lambda k, t: tree_map(lambda x: x[k][:, :, t], batches)  # noqa: E731
    to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        s1, _ = fed._step(start, step_of(0, slice(None)), strat)
        want = kinked_step(fed, s1, step_of(1, slice(None)))[2]
        t1, _ = fed._step(to_dev(start), to_dev(step_of(0, perm)), strat)
        with kink_context(bounds=True) as ctx:
            fed._step(t1, to_dev(step_of(1, perm)), strat)
    inv = torch.argsort(perm)
    got = [(kind, x.cpu()[:, inv], None if s is None else s.cpu()[:, inv])
           for kind, x, s in ctx.records]
    teach, far, first, _ = kink_flips(got, want)
    if first is None:
        return None
    call, kind, agent, idx, t, c, scale = first
    return {"call": call, "kind": kind, "site": ctx.sites[call], "agent": agent,
            "index": idx, "test": t, "checker": c, "scale": scale,
            "near": sum(int(m.sum()) for m, _ in teach), "far": far}


def port_fleet_round_mismatches(device, K=CARD_K):
    """One deferred-straggler fleet round of image_acgan's nets at test
    size (``round_fed``) on ``device`` against the same round on the CPU
    port: 8 clients of 16 numpy samples on 5 slots, the round's cohort with
    a planted ``late:1`` and a ``drop`` under ``StragglerPolicy("defer")``,
    so the round takes the split path (K local steps, the merge through
    ``fedavg_tree`` over the on-time slots, the dropped slot reverted).
    Both runs init on the CPU from one generator and assemble the same
    host batches (the latents come from host generators).  Returns
    ``round_mismatches`` (unsynced: the faulted slots keep their own
    params) and whether the dropped slot holds its start params bit for
    bit on both."""
    from repro_torch.data import FleetRounds, stream_key_schedule
    from repro_torch.run.virtual import StragglerPolicy, VirtualClientDriver, init_generators
    fed = round_fed("image_acgan", K)
    rng = np.random.default_rng(0)
    shards = [{"x": torch.from_numpy(rng.standard_normal((16, 8, 8, 3)).astype(np.float32)),
               "y": torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32))}
              for _ in range(8)]
    extra = lambda g, s: {"z": torch.randn(s + (62,), generator=g)}  # noqa: E731
    fleet = FleetRounds(shards, fed.cfg.agent_grid, ROUND_BATCH, K, sample_extra=extra)
    faults = lambda r, slots: {slots[1]: "late:1", slots[3]: "drop"}  # noqa: E731

    def run(dev):
        drv = VirtualClientDriver(fed, fleet, 1, straggler=StragglerPolicy(mode="defer"),
                                  faults=faults, log_every=0, device=dev)
        out = drv.run(3)
        assert (out.timings["late"], out.timings["dropped"]) == (1, 1)
        return out

    data_rng, init_gen = init_generators(3)
    start = fed.init_state(init_gen(), device="cpu")
    cohort = VirtualClientDriver(fed, fleet, 1, device="cpu").cohort(0)
    batches, _ = fleet.round_batches(stream_key_schedule(data_rng, 1)[0], cohort)
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        want = run("cpu")
        grads = first_step_grads(fed, start, batches)
    got = run(device)
    to_np = lambda t: tree_map(lambda x: x.detach().cpu().numpy(), t)  # noqa: E731
    dropped = all(bool((x[0, 3] == y[0, 3]).all()) for s in (got, want)
                  for x, y in zip(tree_leaves(to_np(s.state["params"])),
                                  tree_leaves(to_np(start["params"]))))
    losses = tuple((r.history[0]["d_loss"], r.history[0]["g_loss"]) for r in (got, want))
    return round_mismatches(tpaper.ALL_EXPERIMENTS["image_acgan"], K, to_np(got.state),
                            to_np(want.state), to_np(grads), losses, synced=False), dropped


# ---------------------------------------------------------------------------
# One LM GAN round at an arch's .smoke() config, on a device against the CPU
# ---------------------------------------------------------------------------

# The reference's arch smoke round (tests/test_arch_smoke.py): a (1, 2)
# grid, batches of 2 sequences of 16 tokens, SGD at 1e-3.  Under Adam the
# round bounds do not hold the reference to itself there
# (test_torch_lm_gan.py's test_adam_bounds_do_not_hold_the_lm_gan_reference_
# to_itself), so the LM GAN round is held under SGD.
LM_GRID, LM_BATCH, LM_T, LM_LR = (1, 2), 2, 16, 1e-3
LM_EXP = types.SimpleNamespace(opt="sgd", lr_d=LM_LR, lr_g=LM_LR)


def lm_gan_fed(arch, K):
    """The port's LM GAN FedGAN of ``arch``'s ``.smoke()`` config, SGD."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_lm_gan_task
    cfg = get_config(arch).smoke()
    return FedGAN(make_lm_gan_task(cfg), FedGANConfig(agent_grid=LM_GRID, sync_interval=K),
                  opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(LM_LR))), cfg


def lm_gan_batch(cfg, K, grid=LM_GRID, batch=LM_BATCH, T=LM_T, seed=1):
    """One round's numpy batch from numpy's generator: (K, P, A, b, T) int32
    tokens and, for the audio family, (K, P, A, b, S_enc, d_model) float32
    encoder frames."""
    shape = (K,) + tuple(grid) + (batch,)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape + (T,)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (0.1 * rng.standard_normal(shape + (cfg.encoder_seq, cfg.d_model))
                         ).astype(np.float32)
    return out


def lm_gan_round_mismatches(arch, device, K=CARD_K):
    """One LM GAN round of ``arch`` (``lm_gan_fed``) on ``device`` against
    the same round on the CPU port, from one start state (drawn on the CPU
    from a seeded generator, then copied) and the same numpy tokens (and
    frames): ``round_mismatches`` with the CPU round in the reference's
    place."""
    fed, cfg = lm_gan_fed(arch, K)
    batches = tree_map(torch.from_numpy, lm_gan_batch(cfg, K))
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    want, wm = fed.round(start, batches)
    grads = first_step_grads(fed, start, batches)
    to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
    got, gm = fed.round(to_dev(start), to_dev(batches))
    to_np = lambda t: tree_map(lambda x: x.detach().cpu().numpy(), t)  # noqa: E731
    losses = tuple((m["d_loss"][0].item(), m["g_loss"][0].item()) for m in (gm, wm))
    return round_mismatches(LM_EXP, K, to_np(got), to_np(want), to_np(grads), losses)


def sync_cases(L):
    """(strategy, calls of each sync kernel wrapper a round) under the
    plain average (one bucketed launch for G, one for D), the fused int8
    sync (one qsync for each) and the composed top-k + int4 sync (per
    float32 leaf one fedavg and, per direction, quant, pack4, unpack4 and
    dequant)."""
    from repro_torch.comm import IntQuant, get_codec
    from repro_torch.core import FedAvgSync
    return {"plain": (None, {"fedavg": 2}),
            "fused": (FedAvgSync(codec=IntQuant(bits=8), error_feedback=True), {"qsync": 2}),
            "composed": (FedAvgSync(codec=get_codec("topk+int4", fraction=0.25),
                                    error_feedback=True),
                         {"fedavg": L, "quant": 2 * L, "pack4": 2 * L, "unpack4": 2 * L,
                          "dequant": 2 * L})}


# ---------------------------------------------------------------------------
# Every sync kernel launch held against its plain version, in place
# ---------------------------------------------------------------------------

HOLD_COLUMNS = 1 << 24   # plain versions run on column chunks this wide


class _Held:
    """A kernel wrapper that, after each call, holds its outputs to
    ``hold(out, *args, **kwargs)``; ``launches`` is the wrapper's own."""

    def __init__(self, fn, hold):
        self.fn, self.hold = fn, hold

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.hold(out, *args, **kwargs)
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


def _bits_equal(a, b):
    """Equal in every byte: a comparison that sees the sign of zero."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


@contextlib.contextmanager
def held_sync_kernels(columns=HOLD_COLUMNS):
    """While open, every call of a sync kernel's wrapper on the paths of
    the coded and the plain sync (fedavg's float32 route, through the
    collectives and through ``fedavg_tree``, the fleet's deferred merge and
    async flush; its wire route on bfloat16 and float16 leaves and its pod
    route, hierarchical sync's per-pod mean, in every type; qsync; and
    qpack's quant, dequant, pack4 and unpack4) also runs the kernel's plain
    version on the same inputs, ``columns`` columns at a time (every output
    column, or block of 128 columns, depends on its own inputs alone), and
    holds the kernel's outputs to it: fedavg within 1e-6 of sum_b |w_b
    x_bn| (both sum the rounded products in agent order, so the bound is
    slack), the wire and pod routes, qsync's three outputs and the qpack
    kernels' bit for bit.  A pod call on bfloat16 or float16 leaves is
    also noted as ``fedavg_pod_bf16`` or ``fedavg_pod_f16``, as the launch
    counters count it.
    Yields ``{kernel: {"calls", "elements", "widest", "widths",
    "max_abs_err"}}`` (``widths``: the set of column counts held); a
    departure raises ``AssertionError``.  The plain versions launch no
    kernel, so the launch counters count as they do outside."""
    from repro_torch.dist import collectives
    from repro_torch.kernels.fedavg import ops as fops
    from repro_torch.kernels.fedavg.ref import (fedavg_flat_ref, fedavg_pod_low_ref,
                                                fedavg_pod_ref, fedavg_wire_ref)
    from repro_torch.kernels.qpack import kernel as pk
    from repro_torch.kernels.qpack import ref as pref
    from repro_torch.kernels.qsync import kernel as qk
    from repro_torch.kernels.qsync.ref import qsync_flat_ref
    stats = {}

    def note(name, shape, err):
        r = stats.setdefault(name, {"calls": 0, "elements": 0, "widest": (0, 0),
                                    "widths": set(), "max_abs_err": 0.0})
        r["calls"] += 1
        r["widths"].add(int(shape[-1]))
        r["elements"] += int(np.prod(shape))
        r["widest"] = max(r["widest"], tuple(shape), key=lambda s: s[-1])
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def spans(n, step):
        return [(i, min(i + step, n)) for i in range(0, n, step)]

    def hold_fedavg(out, weights, stacked):
        err = 0.0
        for a, b in spans(stacked.shape[1], columns):
            x = stacked[:, a:b]
            want = fedavg_flat_ref(weights, x)
            bound = 1e-6 * (weights.float().reshape(-1, 1) * x.float()).abs().sum(0)
            diff = (out[a:b].float() - want.float()).abs()
            assert bool((diff <= bound).all()), \
                f"fedavg {tuple(stacked.shape)}: columns {a}:{b} off by {float(diff.max())}"
            err = max(err, float(diff.max()))
        note("fedavg", stacked.shape, err)

    def hold_wire(out, weights, stacked):
        for a, b in spans(stacked.shape[1], columns):
            assert _bits_equal(out[a:b], fedavg_wire_ref(weights, stacked[:, a:b])), \
                f"fedavg_wire {tuple(stacked.shape)}: columns {a}:{b} differ"
        note("fedavg_wire", stacked.shape, 0.0)

    def hold_pod(out, weights, stacked):
        ref = fedavg_pod_ref if stacked.dtype == torch.float32 else fedavg_pod_low_ref
        for a, b in spans(stacked.shape[2], columns):
            assert _bits_equal(out[:, a:b], ref(weights, stacked[:, :, a:b])), \
                f"fedavg_pod {tuple(stacked.shape)} {stacked.dtype}: columns {a}:{b} differ"
        note("fedavg_pod", stacked.shape, 0.0)
        route = {torch.bfloat16: "fedavg_pod_bf16", torch.float16: "fedavg_pod_f16"}
        if stacked.dtype in route:
            note(route[stacked.dtype], stacked.shape, 0.0)

    def hold_qsync(out, weights, stacked, ef=None, ef_down=None, *, qmax, block=128):
        for a, b in spans(stacked.shape[1], columns - columns % block):
            want = qsync_flat_ref(weights, stacked[:, a:b],
                                  ef[:, a:b] if ef is not None else None,
                                  ef_down[a:b] if ef_down is not None else None,
                                  qmax=qmax, block=block)
            got = (out[0][a:b], out[1][:, a:b] if out[1] is not None else None,
                   out[2][a:b] if out[2] is not None else None)
            for what, g, w in zip(("synced", "new_ef", "new_ef_down"), got, want):
                assert (g is None) == (w is None) and (w is None or _bits_equal(g, w)), \
                    f"qsync {tuple(stacked.shape)} {what}: columns {a}:{b} differ"
        note("qsync", stacked.shape, 0.0)

    def hold_quant(out, x, *, qmax, block=128):
        for a, b in spans(x.shape[1], columns - columns % block):
            wq, ws = pref.quant_blocks_ref(x[:, a:b], qmax=qmax, block=block)
            assert _bits_equal(out[0][:, a:b], wq) and \
                _bits_equal(out[1][:, a // block:b // block], ws), \
                f"quant {tuple(x.shape)}: columns {a}:{b} differ"
        note("quant", x.shape, 0.0)

    def hold_dequant(out, q, scales, *, block=128):
        for a, b in spans(q.shape[1], columns - columns % block):
            want = pref.dequant_blocks_ref(q[:, a:b], scales[:, a // block:b // block],
                                           block=block)
            assert _bits_equal(out[:, a:b], want), f"dequant {tuple(q.shape)}: columns {a}:{b}"
        note("dequant", q.shape, 0.0)

    def hold_pack4(out, q):
        for a, b in spans(q.shape[1], columns):
            assert _bits_equal(out[:, a // 2:b // 2], pref.pack4_ref(q[:, a:b])), \
                f"pack4 {tuple(q.shape)}: columns {a}:{b} differ"
        note("pack4", q.shape, 0.0)

    def hold_unpack4(out, p):
        for a, b in spans(p.shape[1], columns):
            assert _bits_equal(out[:, 2 * a:2 * b], pref.unpack4_ref(p[:, a:b])), \
                f"unpack4 {tuple(p.shape)}: columns {a}:{b} differ"
        note("unpack4", p.shape, 0.0)

    patches = [(collectives._REDUCE, torch.float32, hold_fedavg),
               (collectives._REDUCE, torch.bfloat16, hold_wire),
               (collectives._REDUCE, torch.float16, hold_wire),
               (collectives, "fedavg_pod_flat", hold_pod),
               (fops, "fedavg_flat", hold_fedavg),
               (qk, "qsync_flat", hold_qsync), (pk, "quant_flat", hold_quant),
               (pk, "dequant_flat", hold_dequant), (pk, "pack4_flat", hold_pack4),
               (pk, "unpack4_flat", hold_unpack4)]
    saved = []
    try:
        for where, key, hold in patches:
            get = where.get if isinstance(where, dict) else functools.partial(getattr, where)
            fn = get(key)
            saved.append((where, key, fn))
            if isinstance(where, dict):
                where[key] = _Held(fn, hold)
            else:
                setattr(where, key, _Held(fn, hold))
        yield stats
    finally:
        for where, key, fn in saved:
            if isinstance(where, dict):
                where[key] = fn
            else:
                setattr(where, key, fn)


def query_row_cuts(T: int, n: int) -> list:
    """Each of ``n`` ranks' query rows under ``Shard(1)`` of T rows,
    DTensor's uneven cut (``torch.chunk``'s): ceil(T / n) rows a rank, the
    last ranks fewer or none."""
    size = -(-T // n)
    return [slice(min(r * size, T), min((r + 1) * size, T)) for r in range(n)]


def attend_by_rows(fn, q, k, v, positions, cotangent, n: int):
    """Attention split by query rows as its ``n`` ranks run it, one rank
    after another and with no process group: rank r calls ``fn(q_r, k, v,
    positions_r)`` on its cut of q's rows and of ``positions`` (1 or B, T),
    k and v whole, and pulls its rows of ``cotangent`` back by
    ``torch.autograd``.  Returns the output and q's gradient, each the
    ranks' rows concatenated, and the ranks' k and v gradients, one each
    (partial sums: the split's gradients are their sum)."""
    ys, dqs, dks, dvs = [], [], [], []
    for rows in query_row_cuts(q.shape[1], n):
        q_r = q[:, rows].detach().requires_grad_(True)
        k_r, v_r = (t.detach().requires_grad_(True) for t in (k, v))
        y = fn(q_r, k_r, v_r, positions[:, rows])
        grads = torch.autograd.grad(y, (q_r, k_r, v_r), cotangent[:, rows], allow_unused=True)
        dq, dk, dv = (torch.zeros_like(t) if g is None else g
                      for g, t in zip(grads, (q_r, k_r, v_r)))
        ys.append(y.detach())
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
    return torch.cat(ys, 1), torch.cat(dqs, 1), dks, dvs


def stacked_reduce(t, op: str):
    """The reduction over key slices stacked in a leading dim, the stand-in
    of the all-reduce over the mesh dims that split the keys."""
    return t.amax(0) if op == "max" else t.sum(0)


def decode_by_slices(q, k, v, valid, n_keys: int, n_hd: int, *, merge=None,
                     reduce=stacked_reduce, valid_cut=None):
    """Decode attention split by the cache's keys over ``n_keys`` ranks and
    by head_dim over ``n_hd`` as they run it, one slice after another and
    with no process group: q (B, 1, heads, head_dim), k and v (B, S, kv
    heads, head_dim), ``valid`` (S,) or (B, S); each cut as DTensor cuts
    (``query_row_cuts``).  The port's per-rank steps
    (``models.layers._decode_logits``, ``_decode_part``, ``_decode_out``):
    every (keys, head_dim) slice's partial logits, summed over the head_dim
    slices in slice order; each key slice's part masked by its cut of
    ``valid``; the parts merged over the key slices by ``merge`` (the
    port's ``_merge_keys``) with the slices stacked in a leading dim and
    reduced by ``reduce``.  Returns y like q, the head_dim slices
    concatenated.  ``merge``, ``reduce`` and ``valid_cut(r, cut)`` (the
    columns of ``valid`` key slice r reads; its own cut by default) plant
    faults."""
    from repro_torch.models import layers
    hd = q.shape[-1]
    keys, dims = query_row_cuts(k.shape[1], n_keys), query_row_cuts(hd, n_hd)
    merge = merge or layers._merge_keys
    valid_cut = valid_cut or (lambda r, cut: cut)
    logits = [functools.reduce(torch.add, [layers._decode_logits(q[..., d], k[:, cut][..., d])
                                           for d in dims]) for cut in keys]
    ys = []
    for d in dims:
        tops, parts = zip(*(layers._decode_part(logits[r], v[:, cut][..., d],
                                                valid[..., valid_cut(r, cut)], hd)
                            for r, cut in enumerate(keys)))
        ys.append(layers._decode_out(merge(torch.stack(tops), torch.stack(parts), reduce),
                                     q[..., d]))
    return torch.cat(ys, -1)
