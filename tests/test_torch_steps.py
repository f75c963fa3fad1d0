"""The taught hold of a K-step FedGAN round (``torch_shared.taught_mismatches``)
against the reference: the port's step k runs from the reference's state
after step k - 1 and is held to the reference's step k at one step's
bounds, and the port's sync from the reference's state before its sync is
held to the reference's sync bit for bit.  At the paper's K a free round
departs from step 2 on (a rounding difference moves an activation across
its kink, ``torch_shared.CARD_K``); a taught one leaves nothing to
amplify, so it holds Adam's carried moments, its bias correction past the
first step and the rate schedule at n > 0, which a hold at K = 1 cannot
see.  toy_2d runs SGD under a power decay, so its steps read a(n) at
n > 0; the Adam experiments run at a constant rate.

Also: the port's ``FedGAN.round`` is its own ``_step`` K times and then the
strategy's ``round_sync``, bit for bit, so the taught hold speaks for the
round.  The port runs with oneDNN off, as every round held to the
reference (its convolution backward under the agent vmap is not exact
float32)."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import (_EPS_ZONE, _KINK_ROUNDING, _TIGHT, _UNIT,  # noqa: F401
                          kink_flips, one_torch_thread, paper_step_hold,
                          port_kinks, port_steps, round_fed, round_inputs,
                          round_mismatches, taught_mismatches)

from repro.configs import paper_gans as jpaper
from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig
from repro.core.strategies import FedAvgSync as JSync
from repro.launch import train as jtrain

from repro_torch import nn as tnn
from repro_torch.comm import IntQuant
from repro_torch.configs import paper_gans as tpaper
from repro_torch.convert import from_jax_params
from repro_torch.core import FedAvgSync
from repro_torch.optim import TimeScales
from repro_torch.optim.optimizer import Optimizer
from repro_torch.tree import tree_leaves, tree_map

K = 4
# the reference's task of each experiment held; the port's and the batch
# layout are ``torch_shared.ROUND_TASKS``'
STEP_CASES = {
    "toy_2d": jtrain.toy2d_task,
    "image_acgan": functools.partial(jtrain.acgan_task, hw=8),
    "celeba_acgan": functools.partial(jtrain.acgan_task, hw=8, num_classes=16),
    "timeseries_cgan": jtrain.cgan1d_task,
}


class _Recorder:
    """The reference's ReLUs and leaky ReLUs, patched while a step is
    traced, hand each agent's activation input to the host at run time
    (``jax.debug.callback``, unrolled over the agent vmaps), tagged with
    the call's index in trace order and the agent's index (an extra batch
    entry the losses never read)."""

    def __init__(self):
        self.calls, self.tag, self.store, self.grads = [], None, {}, None

    def _keep(self, call, agent, x):
        self.store[call, int(agent)] = np.asarray(x)

    def patch(self, kind, fn):
        def act(x, *args, **kw):
            call = len(self.calls)
            self.calls.append(kind)
            jax.debug.callback(functools.partial(self._keep, call), self.tag, x)
            return fn(x, *args, **kw)
        return act

    def tagged(self, loss):
        def run(params, batch, rng):
            self.tag = batch["agent"]
            return loss(params, batch, rng)
        return run

    def keep_grads(self, gd, gg):
        self.grads = {"disc": gd, "gen": gg}

    def take(self, B):
        """This step's records, (kind, (B, ...) tensor) per call, and its
        gradients as the strategy's ``grad_hook`` received them."""
        out = [(kind, torch.from_numpy(np.stack([self.store[c, b] for b in range(B)])), None)
               for c, kind in enumerate(self.calls)]
        self.store = {}
        return out, self.grads


class _JSeen(JSync):
    """The reference's plain sync, its ``grad_hook`` handing each step's
    (P, A, ...) gradients to ``rec`` at run time."""

    def __init__(self, rec):
        super().__init__()
        object.__setattr__(self, "_rec", rec)

    def grad_hook(self, fed, gd, gg, state):
        jax.debug.callback(self._rec.keep_grads, gd, gg)
        return super().grad_hook(fed, gd, gg, state)


@contextlib.contextmanager
def _patched(rec):
    relu, leaky = jax.nn.relu, jax.nn.leaky_relu
    jax.nn.relu, jax.nn.leaky_relu = rec.patch("relu", relu), rec.patch("leaky_relu", leaky)
    try:
        yield
    finally:
        jax.nn.relu, jax.nn.leaky_relu = relu, leaky


@functools.lru_cache(maxsize=None)
def _jax_fed(name):
    """The reference's FedGAN of ``name`` at test size, its jitted
    ``_step`` and its ``_Recorder``."""
    jexp = jpaper.ALL_EXPERIMENTS[name]
    jo = jpaper.optimizer_for(jexp)
    rec = _Recorder()
    task = STEP_CASES[name]()[0]
    task = dataclasses.replace(task, disc_loss=rec.tagged(task.disc_loss),
                               gen_loss=rec.tagged(task.gen_loss))
    jfed = JFedGAN(task, JConfig(agent_grid=round_inputs(name, K)[0], sync_interval=K,
                                 strategy=_JSeen(rec)),
                   opt_d=jo[0], opt_g=jo[1], scales=jpaper.scales_for(jexp))
    return jfed, jax.jit(jfed._step), rec


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """The reference's round of ``name`` at test size, step by step: its
    K + 1 states (before each step and after the last), each step's
    metrics (the agent means of the losses), its sync (the strategy's
    ``round_sync`` op by op) and each step's activation inputs (the
    checker's kinks).  Each step is the jitted ``FedGAN._step`` with the
    uint32 seeds the round tests pass, its activation inputs read out by
    ``_Recorder``: the states come from that same program."""
    grid, batches = round_inputs(name, K)
    B = grid[0] * grid[1]
    jfed, step, rec = _jax_fed(name)
    agent = jnp.arange(B, dtype=jnp.int32).reshape(grid)
    states, metrics, kinks, grads = [jax.jit(jfed.init_state)(jax.random.key(0))], [], [], []
    with _patched(rec):
        for k in range(K):
            batch = {key: jnp.asarray(v[k]) for key, v in batches.items()}
            s, m = step(states[-1], ({**batch, "agent": agent}, jnp.zeros(grid, jnp.uint32)))
            jax.block_until_ready(s)
            jax.effects_barrier()
            states.append(s)
            metrics.append(m)
            records, g = rec.take(B)
            kinks.append(records)
            grads.append(g)
    synced = jfed.cfg.resolve_strategy().round_sync(jfed, states[-1])
    return tuple(jax.device_get(x) for x in (states, metrics, synced)) + (kinks, grads)


def _checker(name):
    """``_jax_steps`` as the port's trees on the CPU (the checker of
    ``taught_mismatches``)."""
    states, metrics, synced, _, grads = _jax_steps(name)
    tensors = lambda t: from_jax_params(t, device="cpu")  # noqa: E731
    return ([tensors(s) for s in states],
            [{k: torch.tensor(float(v)) for k, v in m.items()} for m in metrics],
            tensors(synced), [tensors(g) for g in grads])


def _taught(name, *, opts=None, scales=None, upto=None):
    """The port's taught round of ``name`` (its first ``upto`` steps when
    given) against the reference's steps, kinks taught from the
    reference's where a step departs.  Returns ``taught_mismatches``'."""
    fed = round_fed(name, K, opts=opts, scales=scales)
    return taught_mismatches(fed, _checker(name), round_inputs(name, K)[1], "cpu",
                             paper_step_hold(tpaper.ALL_EXPERIMENTS[name]),
                             kinks=lambda k: _jax_steps(name)[3][k - 1], upto=upto)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_taught_steps_and_sync_match_jax(name):
    """Steps 1..4 of the port, each from the reference's state before it,
    within one step's round bounds of the reference's (a step that departs
    is run again with its kinks taught, ``torch_shared.taught_step``); the
    port's sync from the reference's state before its sync equal to the
    reference's bit for bit (the plain average sums the agents in order
    from +0, as the reference does op by op).  The step counter and the
    losses of every step agree too (``round_mismatches``).  Against this
    reference, image_acgan's step 2 and timeseries_cgan's step 3 hold with
    a kink or two taught, timeseries_cgan's step 1 with its eps zone
    taught (``test_first_step_bound_misses_the_reference_itself``).  Where
    kinks are taught, every activation input of the port differs from the
    reference's by less than the kink window, _KINK_ROUNDING times its
    rounding scale (the ``spread``)."""
    steps, (bad_sync, _, differ) = _taught(name)
    for k, (bad, (ratio, path), how) in enumerate(steps, 1):
        assert bad == [], (k, bad, ratio, path, how)
        assert how is None or (how["far"] == 0 and how["spread"] < _KINK_ROUNDING), how
    assert bad_sync == [] and differ == 0


def test_first_step_bound_misses_the_reference_itself():
    """The reference's own step 1 of timeseries_cgan's K = 4 round, on the
    same batch with each agent's samples in another order (the same
    arithmetic, rounded in another order), departs from its step 1 by more
    than the round bounds allow, on disc/conv/14/b, with no kink flipped:
    Adam's first update lr g / (|g| + eps) turns the rounding of gradients
    near eps (yet past the zero-to-rounding rule) into more than the tight
    bound: those elements' gradients lie within ``_EPS_ZONE`` eps of 0.  So
    the taught step teaches the checker's gradient elements that near 0
    (``torch_shared.eps_zone``) where Adam's first step still departs.
    Step 2 of the same round holds the reference to itself."""
    name = "timeseries_cgan"
    exp = tpaper.ALL_EXPERIMENTS[name]
    grid, batches = round_inputs(name, K)
    jstates, jmetrics, _, _, jgrads = _jax_steps(name)
    step = _jax_fed(name)[1]
    perm = np.random.default_rng(1).permutation(batches["x"].shape[3])
    agent = jnp.arange(grid[0] * grid[1], dtype=jnp.int32).reshape(grid)
    ratios = []
    for k in (1, 2):
        batch = {key: jnp.asarray(v[k - 1][:, :, perm]) for key, v in batches.items()}
        got, gm = step(jstates[k - 1], ({**batch, "agent": agent}, jnp.zeros(grid, jnp.uint32)))
        losses = tuple((float(m["d_loss"]), float(m["g_loss"])) for m in (gm, jmetrics[k - 1]))
        bad, (ratio, path) = round_mismatches(exp, 1, jax.device_get(got), jstates[k],
                                              jgrads[k - 1], losses, synced=False, step=k)
        ratios.append((ratio, path, len(bad)))
        if k == 1:
            got_1 = jax.device_get(got)
    assert ratios[0][0] > 1 and ratios[0][1] == "disc/conv/14/b", ratios
    assert all(r[2] == 0 for r in ratios[1:]), ratios
    # the elements over the tight bound there lie in the eps zone
    lr = exp.lr_d
    d = np.abs(np.asarray(got_1["params"]["disc"]["conv"][14]["b"])
               - np.asarray(jstates[1]["params"]["disc"]["conv"][14]["b"]))
    over = d > _TIGHT * lr + 4 * np.spacing(np.float32(lr))
    g = np.abs(np.asarray(jgrads[0]["disc"]["conv"][14]["b"]))
    assert over.any() and (g[over] <= _EPS_ZONE * 1e-8).all(), g[over] / 1e-8


def test_kink_flips_teach_only_flips_within_rounding():
    """``kink_flips`` lists the inputs on which the two sides take opposite
    branches: within _KINK_ROUNDING of the test side's rounding scale
    (unit roundoff times its ``_Rounding`` bound, per element) it teaches
    the checker's branch, farther it only counts them; without a bound it
    teaches none."""
    checker = torch.tensor([[1.0, -1e-7, 2e-7, -0.5], [4.0, 0.5, -1e-6, 1e-4]])
    test = torch.tensor([[1.0, 1e-7, 2e-7, 0.5], [4.0, 0.5, 1e-6, -1e-4]])
    bound = torch.tensor([[1e-7] * 4, [2e-7] * 4]) / _UNIT   # scales 1e-7, 2e-7
    (mask, branch), = kink_flips([("leaky_relu", test, bound)],
                                 [("leaky_relu", checker, None)])[0]
    assert mask.tolist() == [[False, True, False, False], [False, False, True, False]]
    assert not branch[0, 1] and not branch[1, 2]
    teach, far, first, spread = kink_flips([("relu", test, bound)], [("relu", checker, None)])
    assert far == 2 and first == (0, "relu", 0, (1,), pytest.approx(1e-7),
                                  pytest.approx(-1e-7), pytest.approx(1e-7))
    assert spread == pytest.approx(1e7)   # (0, 3): |difference| 1 over 1e-7
    assert kink_flips([("relu", test, None)], [("relu", checker, None)])[1] == 4


@dataclasses.dataclass(frozen=True)
class _Planted(Optimizer):
    """Adam with a fault that leaves its first step as it is:
    ``moments_reset`` zeroes the moments before every step,
    ``count_frozen`` runs the bias correction at count 1 at every step."""

    inner: Optimizer
    fault: str

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state, lr):
        if self.fault == "moments_reset":
            zero = lambda t: tree_map(torch.zeros_like, t)  # noqa: E731
            return self.inner.update(params, grads, {**state, "mu": zero(state["mu"]),
                                                     "nu": zero(state["nu"])}, lr)
        assert self.fault == "count_frozen"
        new, out = self.inner.update(params, grads,
                                     {**state, "count": torch.zeros_like(state["count"])}, lr)
        return new, {**out, "count": state["count"] + 1}


def _rate_at_zero(scales):
    """The rates read at n = 0 at every step."""
    at0 = lambda f: (lambda n: f(torch.zeros_like(n)))  # noqa: E731
    return TimeScales(a=at0(scales.a), b=at0(scales.b), equal=scales.equal)


def _own_round(name, K_=2):
    """``name``'s FedGAN at test size, its batches, and the port's own
    correct round step by step from one start state (the checker), with
    the checker's activation inputs of each step."""
    fed = round_fed(name, K_)
    batches = round_inputs(name, K_)[1]
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    checker = port_steps(fed, start, tree_map(torch.from_numpy, batches))
    of = port_kinks(fed, checker[0], batches)
    return fed, batches, checker, [of(k) for k in range(1, K_ + 1)]


def _held_own(fed, name, batches, checker, kinks):
    exp = tpaper.ALL_EXPERIMENTS[name]
    return taught_mismatches(fed, checker, batches, "cpu", paper_step_hold(exp),
                             kinks=lambda k: kinks[k - 1])[0]


PLANTED = {
    "moments_reset": ("mixed_gaussian", "opts"),
    "count_frozen": ("mixed_gaussian", "opts"),
    "rate_at_n0": ("toy_2d", "scales"),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_taught_hold_sees_what_a_first_step_cannot(fault):
    """Three faults that leave step 1 as it is: Adam's moments zeroed
    before every step, its bias correction frozen at count 1 (mixed_gaussian,
    against the port's own correct round), the learning rate read at n = 0
    at every step (toy_2d against the reference: its SGD rate decays; at a
    constant rate this fault changes nothing).  Each passes the taught
    step 1, as the card's round at ``CARD_K`` = 1 would, and fails the
    taught step 2, kinks taught or not."""
    name, where = PLANTED[fault]
    exp = tpaper.ALL_EXPERIMENTS[name]
    if where == "opts":
        fed, batches, checker, kinks = _own_round(name)
        faulty = round_fed(name, 2, opts=tuple(_Planted(o, fault)
                                               for o in tpaper.optimizer_for(exp)))
        steps = _held_own(faulty, name, batches, checker, kinks)
    else:
        steps, _ = _taught(name, scales=_rate_at_zero(tpaper.scales_for(exp)), upto=2)
    assert steps[0][0] == [], steps[0]
    assert steps[1][0] != [], steps[1]


def test_taught_tiers_do_not_hide_a_gradient_fault():
    """A fault of the backward alone (the discriminator's gradients 1% too
    large, its loss as it was) against the port's own correct round as the
    checker (mixed_gaussian, Adam): the taught step 1 holds it (Adam's
    first update follows the gradient's sign), and step 2 departs, kinks
    and eps zone taught or not: the tiers of ``held_step`` teach only
    elements that rounding decides."""
    name = "mixed_gaussian"
    fed, batches, checker, kinks = _own_round(name)
    loss = fed.task.disc_loss
    steep = lambda p, b: (lambda v: v + 0.01 * (v - v.detach()))(loss(p, b))  # noqa: E731
    faulty = dataclasses.replace(fed, task=dataclasses.replace(fed.task, disc_loss=steep))
    steps = _held_own(faulty, name, batches, checker, kinks)
    assert steps[0][0] == [], steps[0]
    assert steps[1][0] != [] and steps[1][2] is not None, steps[1]


def test_eps_zone_does_not_hide_a_small_gradient_fault():
    """A backward that flushes every gradient element under 1e-4 to 0
    (mixed_gaussian, Adam), against the port's own correct round: its
    step 1, Adam's first, departs, eps zone taught or not, since the zone
    takes only the checker's elements within ``_EPS_ZONE`` eps (1.28e-6)
    of 0, a set no fault can grow."""
    name = "mixed_gaussian"
    fed, batches, checker, kinks = _own_round(name)
    flush = lambda t: tree_map(lambda g: torch.where(g.abs() < 1e-4, 0.0, g), t)  # noqa: E731

    def grads(params, batch):
        gd, gg, metrics = fed._agent_grads(params, batch)
        return flush(gd), flush(gg), metrics
    faulty = dataclasses.replace(fed, task=dataclasses.replace(fed.task, fused_grads=grads))
    bad, _, how = _held_own(faulty, name, batches, checker, kinks)[0]
    assert bad != [] and how["zone"] > 0, (bad, how)


def test_kink_window_does_not_hide_a_forward_fault(monkeypatch):
    """A fault at the kink: mixed_gaussian's dense layers mirror every
    output within 1e-5 of their largest (x -> -x there), so those ReLU
    inputs flip, far past their rounding.  A window of 1e-5 of a call's
    largest input would teach every one of them; the window of the
    rounding bound teaches none, and a taught step departs with flips
    farther than rounding."""
    name = "mixed_gaussian"
    fed, batches, checker, kinks = _own_round(name)
    dense = tnn.Dense.apply

    def mirrored(self, params, x):
        y = dense(self, params, x)
        return torch.where(y.abs() < 1e-5 * y.abs().amax(), -y, y)
    monkeypatch.setattr(tnn.Dense, "apply", mirrored)
    steps = _held_own(fed, name, batches, checker, kinks)
    assert any(bad != [] and how["far"] > 0 for bad, _, how in steps), steps


SYNCS = {"plain": FedAvgSync(),
         "int8_ef": FedAvgSync(codec=IntQuant(8), error_feedback=True)}


@pytest.mark.parametrize("sync", sorted(SYNCS))
def test_round_is_its_steps_then_the_sync(sync):
    """``FedGAN.round`` equals its own ``_step`` K times followed by the
    strategy's ``round_sync``, bit for bit (every leaf of the state,
    the EF residuals too, and each step's metrics), for the plain average
    and for the int8 sync with error feedback; so a hold of the steps and
    the sync, each taught, holds the round."""
    fed = round_fed("mixed_gaussian", K, strategy=SYNCS[sync])
    batches = tree_map(torch.from_numpy, round_inputs("mixed_gaussian", K)[1])
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    got, gm = fed.round(start, batches)
    _, metrics, want, _ = port_steps(fed, start, batches)
    bits = lambda t: [x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
                      for x in tree_leaves(t)]
    assert all(torch.equal(a, b) for a, b in zip(bits(got), bits(want)))
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for key in gm:
        assert torch.equal(gm[key], torch.stack([m[key] for m in metrics]))


if __name__ == "__main__":
    # The first activation that flips at step 2 of image_acgan's free K = 2
    # round on the CPU, the port against itself on the same batches with
    # each agent's samples in another order (the case of
    # test_torch_paper.py's test_second_step_amplifies_a_flip_so_the_card_
    # round_takes_one), with its rounding scale; then, at each taught step
    # of the ACGAN and time-series rounds against the reference, the
    # largest |port - reference| activation input over its rounding scale
    # (the kink window is _KINK_ROUNDING of it) and the flips.
    from torch_shared import free_flip, kinked_step
    torch.set_num_threads(4)
    print("image_acgan free K = 2, CPU reordered against CPU:",
          free_flip("image_acgan", "cpu", order=1))
    for name in ("celeba_acgan", "image_acgan", "timeseries_cgan"):
        states, batches = _checker(name)[0], round_inputs(name, K)[1]
        fed = round_fed(name, K)
        for k in range(1, K + 1):
            batch = tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x[k - 1])),
                             batches)
            with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
                records = kinked_step(fed, states[k - 1], batch, bounds=True)[2]
            near, far, first, spread = kink_flips(records, _jax_steps(name)[3][k - 1])
            print(f"{name} step {k} against the reference: spread {spread:.3g}, "
                  f"{sum(int(m.sum()) for m, _ in near)} flips within rounding, {far} "
                  f"farther, first {first}")
