"""Shared set-up of the port's tests: the image experiment's nets at 8x8
in both packages, the forward-and-gradient parity check of a module
against its JAX twin, one FedGAN round of each paper experiment (and of
the LM GAN at an arch's ``.smoke()`` config) at test size with the bounds
a round is held to, every sync kernel launch held to its plain version in
place (``held_sync_kernels``), and one torch thread per test process (the
tier-1 run puts several pytest workers on the same cores, where torch's
default of one thread per core oversubscribes them).

The module imports JAX and the reference package only inside the helpers
that run them: ``test_torch_cuda.py`` and ``chip_smoke.py`` read the round
bounds on a machine without them.
"""
import contextlib
import dataclasses
import functools
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


def round_mismatches(exp, K, got, want, grads, losses, synced=True):
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
    keep their own)."""
    bad, worst = [], (-1.0, None)
    for k, g, w in zip(("d_loss", "g_loss"), *losses):
        if not np.isclose(g, w, rtol=_LOSS_RTOL, atol=0):
            bad.append((k, g, w))
    if int(got["step"]) != K:
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
    async flush; qsync; and qpack's quant, dequant, pack4 and unpack4) also
    runs the kernel's plain
    version on the same inputs, ``columns`` columns at a time (every output
    column, or block of 128 columns, depends on its own inputs alone), and
    holds the kernel's outputs to it: fedavg within 1e-6 of sum_b |w_b
    x_bn| (both sum the rounded products in agent order, so the bound is
    slack), qsync's three outputs and the qpack kernels' bit for bit.
    Yields ``{kernel: {"calls", "elements", "widest", "widths",
    "max_abs_err"}}`` (``widths``: the set of column counts held); a
    departure raises ``AssertionError``.  The plain versions launch no
    kernel, so the launch counters count as they do outside."""
    from repro_torch.dist import collectives
    from repro_torch.kernels.fedavg import ops as fops
    from repro_torch.kernels.fedavg.ref import fedavg_flat_ref
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
