"""The paper's experiments in the port against the JAX reference, on the
CPU: the 2D-system, MLP and 1-D CGAN nets (forward and gradient, at the
paper's widths), ``Conv1D``, the experiment configurations, the synthetic
stand-in data, one FedGAN round of four experiments, and
``experiment_spec`` for all six.

Tolerances, with their reasons:

* Nets and layers: ``torch_shared._parity`` (atol 1e-5 scaled by the
  leaf's largest magnitude above 1): both sides compute in float32 and
  differ in the summation order of the library products.
* One round from the same state, data and noise (numpy on both sides),
  of toy_2d, mixed_gaussian, celeba_acgan (TTUR, 16 classes, 8x8) and
  timeseries_cgan, held to ``torch_shared.round_mismatches``: SGD 1e-5 of
  each leaf's magnitude, as the image round (``test_torch_round.py``).
  Adam elementwise: 4 float32 ulps of max(|p|, K lr) plus 2e-4 K lr, with
  the lr of the leaf's net, the float32 rounding of the gradients as Adam
  carries it (the largest measured is 3.0e-5 K lr).  Adam scales a step
  whose gradient is rounding noise to about lr with the noise's sign, so
  where some agent's first-step gradient in the reference is nonzero but
  below 1e-5 of its leaf's largest, the bound is 1e-2 K lr (measured at
  most 4.5e-4 K lr); that set is at most 20% of a leaf (measured: 400 of
  67,203 parameters in mixed_gaussian, 10,532 of 332,802 in
  timeseries_cgan, at most 10.4% of one leaf).  celeba_acgan's nets have
  batch norms: the biases that feed them have rounding-noise gradients,
  held to 2 K lr, and in those nets at most 0.1% of each other leaf may
  leave the Adam bound, within 2 K lr (``torch_shared``: the reference
  against itself on a reordered batch needs both).  Planted faults (no
  step, a half step, bias corrections a step ahead, no sync, and
  celeba_acgan's two rates swapped) must fail the comparison.  The port's
  round runs with oneDNN off: its convolution backward under the agent
  vmap is not exact float32 on the CPU, and at the time-series inputs it
  carries the round far past these bounds, where the port's plain float32
  convolution stays within them.
* Synthetic data: the two packages draw other bits from their generators,
  so the port is held to the reference's distributions: exact ranges and
  shapes, and means and spreads within a few standard errors of the
  reference's (4096 or more samples).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import (CARD_K, ROUND_BATCH, ROUND_K, _parity,  # noqa: F401
                          named_leaves, noise_leaves, one_torch_thread,
                          port_round_mismatches, round_fed, round_inputs,
                          round_mismatches)

from repro import nn as jnn
from repro.configs import paper_gans as jpaper
from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import gan_nets as jnets

from repro_torch import nn as tnn
from repro_torch.configs import paper_gans as tpaper
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core.strategies import LocalOnly
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import gan_nets as tnets
from repro_torch.optim.optimizer import Optimizer
from repro_torch.tree import tree_flatten, tree_leaves

EXPERIMENTS = ("toy_2d", "mixed_gaussian", "swiss_roll", "image_acgan",
               "celeba_acgan", "timeseries_cgan")


# ---------------------------------------------------------------------------
# nets and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [24, 7])
@pytest.mark.parametrize("kernel", [5, 1])
def test_conv1d_matches_jax(kernel, T):
    """SAME at stride 1: kernel 5 pads 2 and 2, kernel 1 pads nothing."""
    x = np.random.default_rng(kernel + T).standard_normal((3, T, 6)).astype(np.float32)
    _parity(jnn.Conv1D(6, 4, kernel=kernel), tnn.Conv1D(6, 4, kernel=kernel), [x])


def test_conv1d_same_stride2_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 9, 3)).astype(np.float32)
    _parity(jnn.Conv1D(3, 5, stride=2), tnn.Conv1D(3, 5, stride=2), [x])


def test_toy2d_nets_match_jax():
    z = np.random.default_rng(0).uniform(-1, 1, 64).astype(np.float32)
    _parity(jnets.Toy2DGenerator(theta0=0.5), tnets.Toy2DGenerator(theta0=0.5), [z])
    _parity(jnets.Toy2DDiscriminator(psi0=0.5), tnets.Toy2DDiscriminator(psi0=0.5), [z])


def test_mlp_nets_match_jax():
    """The paper's MLP widths: 3 hidden layers of 128."""
    rng = np.random.default_rng(1)
    z = rng.standard_normal((32, 2)).astype(np.float32)
    _parity(jnets.MLPGenerator(), tnets.MLPGenerator(), [z])
    _parity(jnets.MLPDiscriminator(), tnets.MLPDiscriminator(), [2.0 * z])


def test_cgan1d_nets_match_jax():
    """The paper's 1-D CGAN widths: 8 conv1d(5, 64) layers on 24 steps,
    5 label channels (the climate zones)."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((6, 24)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    kw = dict(seq_len=24, label_dim=5)
    _parity(jnets.CGAN1DGenerator(**kw), tnets.CGAN1DGenerator(**kw), [z, y])
    _parity(jnets.CGAN1DDiscriminator(**kw), tnets.CGAN1DDiscriminator(**kw),
            [rng.random((6, 24)).astype(np.float32), y])


@pytest.mark.parametrize("name", ["toy_2d", "mixed_gaussian", "timeseries_cgan"])
def test_from_jax_params_carries_the_new_trees(name):
    """The reference's agent-stacked state of the new nets (the 0-d
    leaves of the 2D system stacked to (1, B); the ``{"conv", "head"}``
    tree of the 1-D CGAN discriminator with its activation slots) converts
    to the port's own tree: the same structure, shapes and dtypes as the
    port's init, and back to the reference's values bit for bit."""
    jspec, _ = jtrain.experiment_spec(name, K=1, steps=1)
    tspec, _ = ttrain.experiment_spec(name, K=1, steps=1, device="cpu")
    jstate = jax.device_get(jspec.build()[0].init_state(jax.random.key(0)))
    tstate = tspec.build().init_state(torch.Generator().manual_seed(0), device="cpu")
    conv = from_jax_params(jstate, device="cpu")
    got, want = tree_flatten(conv), tree_flatten(tstate)
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(jax.tree_util.tree_leaves(jstate), tree_leaves(to_jax_params(conv))):
        np.testing.assert_array_equal(np.asarray(a), b)
    if name == "toy_2d":
        assert conv["params"]["gen"]["theta"].shape == (1, 5)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_paper_experiments_match_reference(name):
    j, t = jpaper.ALL_EXPERIMENTS[name], tpaper.ALL_EXPERIMENTS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    js, ts = jpaper.scales_for(j), tpaper.scales_for(t)
    assert js.equal == ts.equal
    for n in (0.0, 1.0, 399.0, 3999.0):
        for ja, ta in ((js.a, ts.a), (js.b, ts.b)):
            np.testing.assert_allclose(ta(torch.tensor(n)).item(),
                                       float(ja(jnp.float32(n))), rtol=1e-6)
    for jo, to in zip(jpaper.optimizer_for(j), tpaper.optimizer_for(t)):
        assert type(jo).__name__ == type(to).__name__
        assert dataclasses.asdict(jo) == dataclasses.asdict(to)
    assert sorted(tpaper.ALL_EXPERIMENTS) == sorted(jpaper.ALL_EXPERIMENTS)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _same_moments(t, j, n):
    """Per-column mean and std within 5 standard errors of the reference's."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape
    sd = j.std(0)
    np.testing.assert_array_less(np.abs(t.mean(0) - j.mean(0)), 5 * sd / np.sqrt(n) + 1e-9)
    np.testing.assert_array_less(np.abs(t.std(0) - sd), 5 * sd / np.sqrt(2 * n) + 1e-9)


def test_sample_2d_segment_matches_reference():
    n = 8192
    for i in range(5):
        t = tsyn.sample_2d_segment(_gen(i), n, i, 5).numpy()
        j = np.asarray(jsyn.sample_2d_segment(jax.random.key(i), n, i, 5))
        lo = -1.0 + 0.4 * i
        assert t.shape == (n,) and t.dtype == np.float32
        assert t.min() >= lo - 1e-6 and t.max() <= lo + 0.4 + 1e-6
        _same_moments(t[:, None], j[:, None], n)


def test_sample_mixed_gaussian_matches_reference():
    n = 8192
    np.testing.assert_allclose(tsyn.mixed_gaussian_modes().numpy(),
                               np.asarray(jsyn.mixed_gaussian_modes()), atol=1e-6)
    for sub in ([0, 1], [6, 7], None):
        t = tsyn.sample_mixed_gaussian(_gen(3), n, mode_subset=sub).numpy()
        j = np.asarray(jsyn.sample_mixed_gaussian(jax.random.key(3), n, mode_subset=sub))
        _same_moments(t, j, n)
        modes = tsyn.mixed_gaussian_modes().numpy()
        near = np.linalg.norm(t[:, None] - modes[None], axis=-1).argmin(1)
        assert set(near) == set(sub if sub is not None else range(8))
        assert np.linalg.norm(t - modes[near], axis=-1).max() < 0.4   # 8 sigma


def test_sample_swiss_roll_matches_reference():
    n = 8192
    for tr in ((0.25, 1.0), (0.4375, 0.625)):
        t = tsyn.sample_swiss_roll(_gen(4), n, t_range=tr).numpy()
        j = np.asarray(jsyn.sample_swiss_roll(jax.random.key(4), n, t_range=tr))
        _same_moments(t, j, n)
        r = np.linalg.norm(t, axis=-1)   # t / (3 pi) in [t0, t1], plus noise
        assert r.min() > tr[0] - 0.25 and r.max() < tr[1] + 0.25


def test_sample_household_load_matches_reference():
    n = 4096
    for zone in (0, 4):
        t = tsyn.sample_household_load(_gen(zone), n,
                                       climate_zone=torch.full((n,), zone)).numpy()
        j = np.asarray(jsyn.sample_household_load(
            jax.random.key(zone), n, climate_zone=jnp.full((n,), zone)))
        assert t.shape == (n, 24)
        np.testing.assert_allclose(t.max(1), 1.0, rtol=1e-6)   # normalised to peak 1
        _same_moments(t, j, n)


def test_sample_ev_sessions_matches_reference():
    """Per-hour means within 5 standard errors, and the hour of each
    session's peak distributed alike.  Not the standard deviations: the
    hours outside a session sit in a sigmoid's tail, so heavy-tailed that
    two seeds of the reference differ there by hundreds of standard
    errors of a Gaussian's std."""
    n = 4096
    for cat in (0, 4):
        t = tsyn.sample_ev_sessions(_gen(cat), n, category=torch.full((n,), cat)).numpy()
        j = np.asarray(jsyn.sample_ev_sessions(jax.random.key(cat), n,
                                               category=jnp.full((n,), cat)))
        assert t.shape == (n, 24) and t.min() >= 0.0
        np.testing.assert_allclose(t.max(1), 1.0, rtol=1e-6)   # normalised to peak 1
        t64, j64 = t.astype(np.float64), j.astype(np.float64)
        np.testing.assert_array_less(np.abs(t64.mean(0) - j64.mean(0)),
                                     5 * j64.std(0) / np.sqrt(n) + 1e-9)
        pt = np.bincount(t.argmax(1), minlength=24) / n
        pj = np.bincount(j.argmax(1), minlength=24) / n
        np.testing.assert_array_less(np.abs(pt - pj),
                                     5 * np.sqrt(pj * (1 - pj) / n) + 3 / n)


def test_sample_attribute_faces_matches_reference():
    n = 4096
    attrs = np.random.default_rng(6).integers(0, 16, n)
    t = tsyn.sample_attribute_faces(_gen(6), n, torch.from_numpy(attrs), hw=8).numpy()
    j = np.asarray(jsyn.sample_attribute_faces(jax.random.key(6), n, attrs, hw=8))
    assert t.shape == (n, 8, 8, 3) and t.min() >= -1.0 and t.max() <= 1.0
    _same_moments(t.reshape(n, -1), j.reshape(n, -1), n)


def test_sample_class_images_matches_reference():
    n = 4096
    lab = np.random.default_rng(5).integers(0, 16, n)
    t = tsyn.sample_class_images(_gen(5), n, torch.from_numpy(lab), hw=16,
                                 num_classes=16).numpy()
    j = np.asarray(jsyn.sample_class_images(jax.random.key(5), n, lab, hw=16,
                                            num_classes=16))
    assert t.shape == (n, 16, 16, 3) and t.min() >= -1.0 and t.max() <= 1.0
    _same_moments(t.reshape(n, -1), j.reshape(n, -1), n)


# ---------------------------------------------------------------------------
# one FedGAN round against the reference
# ---------------------------------------------------------------------------


# The reference's task of each experiment whose round is compared; the
# port's task and the batch layout are ``torch_shared.ROUND_TASKS``'.
ROUND_CASES = {
    "toy_2d": jtrain.toy2d_task,
    "mixed_gaussian": jtrain.mlp_gan_task,
    "celeba_acgan": functools.partial(jtrain.acgan_task, hw=8, num_classes=16),
    "timeseries_cgan": jtrain.cgan1d_task,
}


@dataclasses.dataclass(frozen=True)
class _Planted(Optimizer):
    """An optimizer with a planted fault, for the round comparison to
    reject: ``no_step`` leaves the parameters, ``half_step`` halves the
    rate, ``count_ahead`` runs Adam's bias corrections one step ahead."""

    inner: Optimizer
    fault: str

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state, lr):
        if self.fault == "no_step":
            return params, {**state, "count": state["count"] + 1}
        if self.fault == "half_step":
            return self.inner.update(params, grads, state, lr * 0.5)
        assert self.fault == "count_ahead"
        return self.inner.update(params, grads, {**state, "count": state["count"] + 1}, lr)


@functools.lru_cache(maxsize=None)
def _jax_fed(name, K=ROUND_K):
    """The reference's FedGAN of ``name`` at test size, its jitted round
    and its start state."""
    jexp = jpaper.ALL_EXPERIMENTS[name]
    jo = jpaper.optimizer_for(jexp)
    jfed = JFedGAN(ROUND_CASES[name]()[0],
                   JConfig(agent_grid=round_inputs(name, K)[0], sync_interval=K),
                   opt_d=jo[0], opt_g=jo[1], scales=jpaper.scales_for(jexp))
    return jfed, jax.jit(jfed.round), jfed.init_state(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _jax_round(name, K=ROUND_K, order=None):
    """The reference's start state, round result, first-step losses and
    each agent's first-step gradients (disc, gen) for ``name``.  With
    ``order`` (a seed), the round runs on the same batches with each
    agent's samples in another order: the same arithmetic, rounded in
    another order (no gradients then)."""
    jfed, jround, jstate = _jax_fed(name, K)
    grid, batches = round_inputs(name, K)
    if order is not None:
        perm = np.random.default_rng(order).permutation(ROUND_BATCH)
        batches = {k: v[:, :, :, perm] for k, v in batches.items()}
    start = jax.device_get(jstate)
    end, jm = jround(jstate, jax.tree_util.tree_map(jnp.asarray, batches),
                     jnp.zeros((K,) + grid, jnp.uint32))
    if order is not None:
        return start, jax.device_get(end), jax.device_get(jm), None
    B = grid[0] * grid[1]
    flat = lambda t, lead: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x).reshape((B,) + x.shape[lead:]), t)
    key = jax.random.key(0)

    def grads(p, bt):
        gd = jax.grad(lambda d: jfed.task.disc_loss({**p, "disc": d}, bt, key))(p["disc"])
        gg = jax.grad(lambda g: jfed.task.gen_loss({**p, "gen": g}, bt, key))(p["gen"])
        return {"disc": gd, "gen": gg}

    g1 = jax.jit(jax.vmap(grads))(flat(start["params"], 2),
                                  flat({k: v[0] for k, v in batches.items()}, 2))
    return start, jax.device_get(end), jax.device_get(jm), jax.device_get(g1)


def _round_mismatches(name, *, fault=None, K=ROUND_K):
    """Run one round (K local steps then the FedAvg sync) of ``name``'s nets,
    optimizers and schedules in the port, from the reference's init and on
    the same batches, and list every way it departs from the reference's
    round (``torch_shared.round_mismatches``).  ``fault`` plants a known
    defect in the port's round."""
    texp = tpaper.ALL_EXPERIMENTS[name]
    _, batches = round_inputs(name, K)
    start, want, jm, g1 = _jax_round(name, K)
    opts = scales = strategy = None
    if fault == "no_sync":
        strategy = LocalOnly()
    elif fault == "swapped_ttur":   # D at G's rate and G at D's
        scales = tpaper.constant_ttur(texp.lr_g, texp.lr_d)
    elif fault is not None:
        opts = tuple(_Planted(o, fault) for o in tpaper.optimizer_for(texp))
    tfed = round_fed(name, K, opts=opts, scales=scales, strategy=strategy)
    # oneDNN's convolution backward under the agent vmap (a grouped
    # convolution) is not exact float32 on the CPU; the round is held to
    # the reference through the plain float32 convolution.
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        tstate, tm = tfed.round(from_jax_params(start, device="cpu"),
                                from_jax_params(batches, device="cpu"))
    losses = ((tm["d_loss"][0].item(), tm["g_loss"][0].item()),
              (float(jm["d_loss"][0]), float(jm["g_loss"][0])))
    bad, _ = round_mismatches(texp, K, to_jax_params(tstate), want, g1, losses)
    return bad


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_round_matches_jax(name):
    """One round (K = 2 local steps then the FedAvg sync) of the
    experiment's nets, optimizers and schedules, from the reference's init,
    on the same batches (numpy) in both packages: the first step's losses
    within 1e-5, every agent holding the synced value, and each parameter
    within the module docstring's tolerance of the reference's."""
    assert _round_mismatches(name) == []


def test_round_bounds_hold_the_reference_to_itself():
    """celeba_acgan's round in the reference, on the same batches with each
    agent's samples in another order (the same arithmetic, rounded in
    another order), is within the bounds of its own round: the batch-norm
    rule asks no more of the port than the reference meets.  Without it
    the reference would fail itself: the biases that feed a batch norm
    depart by more than 0.1 K lr, as their gradient is rounding noise that
    Adam steps by about lr with the noise's sign.  (A reordering can also
    flip an activation that sits at rounding distance from its kink: one
    of timeseries_cgan's departs 188x its bound, another 0.17x; so the
    other experiments are held to the reference's own order only.)"""
    name = "celeba_acgan"
    texp = tpaper.ALL_EXPERIMENTS[name]
    _, want, jm, g1 = _jax_round(name)
    _, got, om, _ = _jax_round(name, order=1)
    losses = tuple((float(m["d_loss"][0]), float(m["g_loss"][0])) for m in (om, jm))
    assert round_mismatches(texp, ROUND_K, got, want, g1, losses)[0] == []
    noisy = {net: noise_leaves(g1, net) for net in ("disc", "gen")}
    assert noisy == {"disc": {"disc/c2/b", "disc/fc/b"},
                     "gen": {"gen/ct1/b", "gen/fc1/b", "gen/fc2/b"}}
    for net, paths in noisy.items():
        lr = texp.lr_d if net == "disc" else texp.lr_g
        for path in paths:
            leaf = lambda t: dict(named_leaves(t["params"][net], net))[path]  # noqa: E731
            assert float(np.abs(leaf(got) - leaf(want)).max()) > 0.1 * ROUND_K * lr, path


def test_second_step_amplifies_a_flip_so_the_card_round_takes_one():
    """The port against itself on the CPU, on the same batches with each
    agent's samples in another order: at K = 2 image_acgan's round departs
    over 100 times its bounds (on some agents a leaky-ReLU input at
    rounding distance from its kink changes sign, and that agent's second
    Adam step moves), at K = 1 it holds them.  So the card's round is held to the CPU's at ``CARD_K`` = 1."""
    bad, (ratio, _) = port_round_mismatches("image_acgan", "cpu", K=2, order=1)
    assert bad != [] and ratio > 100
    assert port_round_mismatches("image_acgan", "cpu", K=CARD_K, order=1)[0] == []


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_only_the_batch_norm_nets_have_noise_leaves(name):
    """The batch-norm rule of the round bounds reaches celeba_acgan's nets
    alone: every other net keeps the Adam bound on every element."""
    g1 = _jax_round(name)[3]
    assert any(noise_leaves(g1, net) for net in ("disc", "gen")) == (name == "celeba_acgan")


PLANTED = [("toy_2d", f) for f in ("no_step", "half_step", "no_sync")] + [
    (n, f) for n in ("mixed_gaussian", "celeba_acgan", "timeseries_cgan")
    for f in ("no_step", "half_step", "count_ahead", "no_sync")] + [
    ("celeba_acgan", "swapped_ttur")]


@pytest.mark.parametrize("name,fault", PLANTED)
def test_round_comparison_rejects_planted_faults(name, fault):
    """The round comparison fails a port that skips the optimizer step,
    halves it, runs Adam's bias corrections a step ahead, drops the sync,
    or (celeba_acgan, the TTUR experiment) swaps the two nets' rates."""
    assert _round_mismatches(name, fault=fault) != []


# ---------------------------------------------------------------------------
# experiment_spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiment_spec_runs_two_rounds(name):
    """Every experiment builds with the reference's recipe (agents, grid,
    K, batch, shard sizes and shapes) and runs two rounds on the CPU: finite
    losses, every agent holding the synced parameters, an eval with a
    finite FD at the end."""
    jspec, jsuite = jtrain.experiment_spec(name)
    tspec, tsuite = ttrain.experiment_spec(name, device="cpu")
    for f in ("agent_grid", "K", "steps", "batch_size", "log_every"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    assert len(tspec.agent_data) == len(jspec.agent_data)
    for td, jd in zip(tspec.agent_data, jspec.agent_data):
        assert sorted(td) == sorted(jd)
        for k in td:
            assert tuple(td[k].shape) == tuple(np.shape(jd[k])), k
    assert tuple(tsuite.real.shape) == tuple(np.shape(jsuite.real))
    assert (tsuite.modes is None) == (jsuite.modes is None) and tsuite.kind == jsuite.kind
    spec, _ = ttrain.experiment_spec(name, K=1, steps=2, batch_size=4, log_every=0,
                                     eval_every=2, device="cpu")
    result = spec.run_result()
    assert len(result.history) == 2
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    for x in tree_leaves(result.state["params"]):
        assert torch.equal(x, x[:1, :1].expand_as(x))
    assert [e["round"] for e in result.evals] == [1]
    assert np.isfinite(result.evals[0]["fd"])
    extra = {"mixed_gaussian": {"modes_covered", "high_quality_frac"},
             "timeseries_cgan": {"centroid_rmse", "centroid_rmse_random"}}.get(name, set())
    assert set(result.evals[0]) == {"round", "step", "fd"} | extra


def test_experiment_spec_refuses_what_is_not_ported():
    """An unknown experiment is a KeyError.  ``data_mode="stream"``,
    refused until the host-streaming pipeline was ported, now runs, and so
    do ``dp`` since the privacy slice and ``a_total`` (the virtual-client
    fleet, on the host stream) since the fleet slice."""
    spec, _ = ttrain.experiment_spec("toy_2d", device="cpu", a_total=16, K=2, steps=4,
                                     samples_per_agent=32, batch_size=4, log_every=0)
    assert (spec.a_total, spec.data_mode, spec.agent_grid) == (16, "stream", (1, 5))
    result = spec.run_result()
    assert result.timings["data_kind"] == "virtual" and len(result.history) == 2
    assert 5 <= result.timings["store_rows"] <= 16
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    from repro_torch.privacy import DPSGD
    spec, _ = ttrain.experiment_spec("toy_2d", device="cpu", dp=DPSGD(clip=0.5))
    assert spec.build().cfg.dp == DPSGD(clip=0.5)
    with pytest.raises(KeyError):
        ttrain.experiment_spec("cifar", device="cpu")
    spec, _ = ttrain.experiment_spec("toy_2d", K=2, steps=4, batch_size=4, log_every=0,
                                     samples_per_agent=64, device="cpu", data_mode="stream")
    result = spec.run_result()
    assert result.timings["data_kind"] == "stream" and len(result.history) == 2
    assert all(np.isfinite(v) for m in result.history for v in m.values())


def test_train_cli_runs_every_experiment_name_with_evals(capsys):
    """``--experiment`` takes the six names, ``--eval-every`` prints the
    eval rows; the card is the default and refused without one."""
    choices = next(a for a in ttrain.build_parser()._actions
                   if a.dest == "experiment").choices
    assert sorted(choices) == sorted(EXPERIMENTS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--experiment", "toy_2d", "--steps", "2"])
    result = ttrain.main(["--experiment", "mixed_gaussian", "--device", "cpu", "--K", "1",
                          "--steps", "2", "--batch-size", "4", "--eval-every", "1",
                          "--log-every", "0"])
    assert [e["round"] for e in result.evals] == [0, 1]
    assert capsys.readouterr().out.count('"eval": true') == 2
