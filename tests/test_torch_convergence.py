"""The port's convergence instrumentation (paper §3.3, Lemmas 1 and 2)
against the JAX reference, on the CPU.

* ``r1_bound`` and ``r2_bound`` bit for bit at every integer step: r1 in
  float32 (the reference raises to its step as an integer array, so its
  power runs by squaring in float32), r2 in Python floats.
* ``estimate_constants``' sg, sh and mg on the same params, data and
  minibatch indices (``prng.randint`` under the reference's key schedule):
  within 1e-5 relative.
* L: the probe of one direction within 1e-5 relative of the reference's
  formula on the same direction; the estimate itself, a maximum over 8
  random directions whose bits differ between the packages, within 10% of
  the reference's (over 5 parameter seeds and 3 keys the ratio ranged
  from 1.002 to 1.056).
* ``measure_drift`` on the same data: the drifts within 1e-4 relative of
  the reference's, step by step.
* The port twin of ``tests/test_system.py``'s lemma test.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_torch_thread  # noqa: F401

from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig
from repro.core import convergence as jconv
from repro.launch import train as jtrain
from repro.optim import SGD as JSGD, constant as jconst, equal_timescale as jequal

from repro_torch import prng
from repro_torch.convert import from_jax_params
from repro_torch.core import (FedGAN, FedGANConfig, estimate_constants, measure_drift,
                              r1_bound, r2_bound)
from repro_torch.core import convergence as tconv
from repro_torch.launch import train as ttrain
from repro_torch.optim import SGD, constant, equal_timescale

B, K, LR = 5, 10, 0.02


@pytest.mark.parametrize("L", [0.1, 1.0, 3.7, 12.3, 100.0])
@pytest.mark.parametrize("a", [0.001, 0.02, 0.05])
def test_lemma_bounds_match_jax_bit_for_bit(L, a):
    kw = dict(a=a, K=20, L=L, sg=0.5, sh=0.3, mg=0.2)
    for n in range(0, 45):
        want = np.float32(jconv.r1_bound(n, **kw))
        got = r1_bound(n, **kw)
        assert got.dtype == np.float32
        assert np.float32(got).view(np.uint32) == want.view(np.uint32), (n, got, want)
        assert r2_bound(n, **kw) == jconv.r2_bound(n, **kw)
    # an array of steps: each element is the scalar call's (the reference,
    # called with an array, takes another pow algorithm, off by a few ulps)
    ns = np.arange(45)
    np.testing.assert_array_equal(r1_bound(ns, **kw), [r1_bound(n, **kw) for n in ns])


def _agent_data(seed=1, n=2048):
    """Per-agent toy-2D datasets, numpy, agent i's x on its own segment."""
    rng = np.random.default_rng(seed)
    return [{"x": (rng.uniform(i / B, (i + 1) / B, n) * 2 - 1).astype(np.float32),
             "z": rng.uniform(-1, 1, n).astype(np.float32)} for i in range(B)]


def _feds():
    jtask, _ = jtrain.toy2d_task()
    ttask, _ = ttrain.toy2d_task()
    jfed = JFedGAN(jtask, JConfig(agent_grid=(1, B), sync_interval=K), opt_g=JSGD(),
                   opt_d=JSGD(), scales=jequal(jconst(LR)))
    tfed = FedGAN(ttask, FedGANConfig(agent_grid=(1, B), sync_interval=K), opt_g=SGD(),
                  opt_d=SGD(), scales=equal_timescale(constant(LR)))
    return jfed, tfed


def _both(data):
    return ([{k: jnp.asarray(v) for k, v in d.items()} for d in data],
            [{k: torch.from_numpy(v) for k, v in d.items()} for d in data])


def test_constants_match_jax_on_the_same_indices():
    jfed, tfed = _feds()
    jstate = jfed.init_state(jax.random.key(0))
    jparams = jfed.averaged_params(jstate)
    tparams = from_jax_params(jax.device_get(jparams), device="cpu")
    jdata, tdata = _both(_agent_data())
    kw = dict(minibatch=64, n_var_samples=4, n_lip_samples=8)
    want = jconv.estimate_constants(jfed.task, jparams, jdata, jax.random.key(2), **kw)
    got = estimate_constants(tfed.task, tparams, tdata, prng.key(2), **kw)
    for name in ("sigma_g", "sigma_h", "mu_g"):
        assert getattr(got, name) == pytest.approx(getattr(want, name), rel=1e-5), name
    assert got.L == pytest.approx(want.L, rel=0.1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lipschitz_probe_matches_jax_on_the_same_direction(seed):
    """||g(p + eps d) - g(p)|| / eps, the estimate's one probe, on one
    numpy direction d through both packages: within 16 float32 roundings of
    ||g(p)|| + ||g(p + eps d)||, over eps (the difference cancels most of
    the two gradients' digits; the packages round their sums apart)."""
    jfed, tfed = _feds()
    jparams = jfed.averaged_params(jfed.init_state(jax.random.key(seed)))
    tparams = from_jax_params(jax.device_get(jparams), device="cpu")
    jdata, tdata = _both(_agent_data(seed))
    d = np.random.default_rng(seed).standard_normal(2).astype(np.float32)
    d = d / np.linalg.norm(d)
    eps = 1e-2

    def jprobe():
        flat, unflat = jax.flatten_util.ravel_pytree({"disc": jparams["disc"],
                                                      "gen": jparams["gen"]})
        p2 = {**jparams, **unflat(flat + eps * jnp.asarray(d))}
        g1 = jconv._grads(jfed.task, jparams, jdata[0], jax.random.key(0))
        g2 = jconv._grads(jfed.task, p2, jdata[0], jax.random.key(0))
        return float(jconv.tree_diff_norm({"d": g1[0], "g": g1[1]},
                                          {"d": g2[0], "g": g2[1]})) / eps

    t_leaves = [tparams["disc"], tparams["gen"]]
    moved = {"disc": {}, "gen": {}}
    i = 0
    for name, tree in zip(("disc", "gen"), t_leaves):
        for k in sorted(tree):
            moved[name][k] = tree[k] + eps * torch.tensor(d[i]).reshape(tree[k].shape)
            i += 1
    g1 = tconv._grads(tfed.task, tparams, tdata[0])
    g2 = tconv._grads(tfed.task, {**tparams, **moved}, tdata[0])
    got = float(tconv.tree_diff_norm({"d": g1[0], "g": g1[1]}, {"d": g2[0], "g": g2[1]})) / eps
    mag = float(tconv.tree_norm(g1)) + float(tconv.tree_norm(g2))
    assert abs(got - jprobe()) <= 16 * 2.0 ** -24 * mag / eps


def test_measure_drift_matches_jax():
    jfed, tfed = _feds()
    jstate = jfed.init_state(jax.random.key(0))
    tstate = from_jax_params(jax.device_get(jstate), device="cpu")
    jdata, tdata = _both(_agent_data(n=512))
    want = jconv.measure_drift(jfed, jstate, jdata, jax.random.key(3), n_steps=K + 3,
                               minibatch=32)
    got = measure_drift(tfed, tstate, tdata, prng.key(3), n_steps=K + 3, minibatch=32)
    for k in ("agent_drift", "avg_drift", "lr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-7)


def test_drift_stays_below_lemma_bounds():
    """Lemma 1/2: the measured drift of the agents from the virtual
    centralized sequence stays below r1(n)/r2(n) of the estimated
    constants (the port twin of ``tests/test_system.py``'s test, with
    numpy data)."""
    _, fed = _feds()
    state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    agent_data = _both(_agent_data())[1]
    params = fed.averaged_params(state)
    consts = estimate_constants(fed.task, params, agent_data, prng.key(2), minibatch=64,
                                n_var_samples=4, n_lip_samples=4)
    res = measure_drift(fed, state, agent_data, prng.key(3), n_steps=2 * K, minibatch=64)
    for n in range(1, 2 * K):
        if n % K == 0:
            continue  # at the sync points the drift resets to ~0
        bound = float(r1_bound(n, a=LR, K=K, L=consts.L, sg=consts.sigma_g,
                               sh=consts.sigma_h, mg=consts.mu_g))
        measured = float(res["agent_drift"][n - 1])
        assert measured <= bound * 1.5 + 1e-4, (n, measured, bound)
    r2 = float(r2_bound(K, a=LR, K=K, L=consts.L, sg=consts.sigma_g, sh=consts.sigma_h,
                        mg=consts.mu_g))
    assert float(torch.max(res["avg_drift"][:K])) <= max(r2, 0.0) * 2.0 + 1e-3
    assert (res["lr"] == float(np.float32(LR))).all()
