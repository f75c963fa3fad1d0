"""The port's evals, eval harness, K-sweep runner and quickstart on the
CPU, against the JAX reference.

Tolerances, with their reasons:

* ``frechet_distance`` runs the reference's float64 numpy code on the same
  features: within 1e-9 relative.  ``fd_score`` with the projection
  weights of the reference (the two packages draw other random bits) adds
  the float32 products of the projection in another order: within 1e-6
  relative.
* ``mode_stats``, ``wasserstein_1d_proj``, ``kmeans`` and
  ``centroid_match_score`` are copies of the reference's numpy code: equal.
* ``evaluate`` on the reference's state converted to the port, with the
  same noise and projection: the generator's float32 outputs differ in
  the last bits, so the FD within 1e-5 relative and the counts equal.
"""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_torch_thread  # noqa: F401

from repro.evals import fd as jfd, modes as jmodes
from repro.evals.kmeans import centroid_match_score as j_centroid_match, kmeans as j_kmeans
from repro.launch import train as jtrain
from repro.run import evals as jevals, experiments as jexperiments

from repro_torch import quickstart
from repro_torch.convert import from_jax_params
from repro_torch.evals import fd as tfd, modes as tmodes
from repro_torch.evals.kmeans import centroid_match_score as t_centroid_match, kmeans as t_kmeans
from repro_torch.launch import train as ttrain
from repro_torch.run import evals as tevals, experiments as texperiments


def _jax_projection(key, in_dim, feat_dim=64):
    """The reference's projection weights for ``key``, read from its
    feature map's closure."""
    f = jfd.random_feature_fn(key, in_dim, feat_dim)
    w = inspect.getclosurevars(f).nonlocals
    return np.array(w["w1"]), np.array(w["w2"])


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    fr = rng.standard_normal((512, 16)).astype(np.float32)
    ff = (1.3 * rng.standard_normal((512, 16)) + 0.2).astype(np.float32)
    want = jfd.frechet_distance(jnp.asarray(fr), jnp.asarray(ff))
    got = tfd.frechet_distance(torch.from_numpy(fr), torch.from_numpy(ff))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert tfd.frechet_distance(fr, fr) < 1e-6
    np.testing.assert_allclose(tfd._sqrtm_psd(np.diag([4.0, 9.0])), np.diag([2.0, 3.0]))


@pytest.mark.parametrize("shape", [(2,), (24,), (8, 8, 3)], ids=["2d", "series", "image"])
def test_fd_score_matches_jax_with_shared_projection(shape, monkeypatch):
    rng = np.random.default_rng(1)
    real = rng.standard_normal((400,) + shape).astype(np.float32)
    fake = (0.7 * rng.standard_normal((400,) + shape) + 0.3).astype(np.float32)
    key = jax.random.key(5)
    w1, w2 = _jax_projection(key, int(np.prod(shape)))
    monkeypatch.setattr(tfd, "random_feature_fn", lambda gen, in_dim, feat_dim=64:
                        tfd.random_features(torch.from_numpy(w1), torch.from_numpy(w2)))
    want = jfd.fd_score(key, jnp.asarray(real), jnp.asarray(fake))
    got = tfd.fd_score(torch.Generator(), torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_random_feature_fn_draws_a_fixed_projection_on_the_generator_device():
    x = torch.randn((10, 3, 4))
    f1 = tfd.random_feature_fn(torch.Generator().manual_seed(2), 12, feat_dim=8)
    f2 = tfd.random_feature_fn(torch.Generator().manual_seed(2), 12, feat_dim=8)
    assert f1(x).shape == (10, 8) and torch.equal(f1(x), f2(x))
    np.testing.assert_allclose(tfd.fd_score(torch.Generator().manual_seed(3), x, x),
                               0.0, atol=1e-5)


def test_mode_stats_and_wasserstein_match_reference():
    rng = np.random.default_rng(2)
    modes = np.array(jax.device_get(jnp.stack(
        [2 * jnp.cos(jnp.arange(8) * np.pi / 4), 2 * jnp.sin(jnp.arange(8) * np.pi / 4)], -1)))
    s = modes[rng.integers(0, 6, 2000)] + 0.2 * rng.standard_normal((2000, 2))
    for radius in (0.3, 0.5):
        want = jmodes.mode_stats(s, modes, radius=radius)
        got = tmodes.mode_stats(torch.from_numpy(s), torch.from_numpy(modes), radius=radius)
        assert got[0] == want[0] == 6 and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    b = s + 0.5
    assert tmodes.wasserstein_1d_proj(s, b) == jmodes.wasserstein_1d_proj(s, b)


def test_kmeans_and_centroid_match_score_match_reference():
    rng = np.random.default_rng(3)
    centers = 3 * rng.standard_normal((9, 24))
    real = centers[rng.integers(0, 9, 900)] + 0.1 * rng.standard_normal((900, 24))
    fake = centers[rng.integers(0, 9, 900)] + 0.2 * rng.standard_normal((900, 24))
    for got, want in zip(t_kmeans(torch.from_numpy(real), 9, seed=4),
                         j_kmeans(real, 9, seed=4)):
        np.testing.assert_array_equal(got, want)
    got = t_centroid_match(real, fake)
    want = j_centroid_match(real, fake)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["matched_rmse"] < 0.1 * got["random_rmse"]   # the planted clusters


@pytest.mark.parametrize("name", ["mixed_gaussian", "timeseries_cgan"])
def test_evaluate_on_a_converted_state_matches_jax(name, monkeypatch):
    """The reference's state after one round, converted to the port, scored
    by both harnesses with the same generated-sample noise and the same
    projection: the intermediary's average, the FD and the suite's extra
    metrics agree."""
    n = 512
    jspec, jsuite = jtrain.experiment_spec(name, K=2, steps=2, batch_size=8, log_every=0)
    tspec, tsuite = ttrain.experiment_spec(name, K=2, steps=2, device="cpu")
    jres = jspec.run_result()
    jstate = jax.device_get(jres.state)
    tstate = from_jax_params(jstate, device="cpu")
    rng = np.random.default_rng(4)
    z = rng.standard_normal((n,) + {"mixed_gaussian": (2,), "timeseries_cgan": (24,)}[name])
    z = z.astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    real = np.asarray(jsuite.real[:n])
    jG = jtrain.mlp_gan_task()[1][0] if name == "mixed_gaussian" else jtrain.cgan1d_task()[1][0]
    tG = ttrain.mlp_gan_task()[1][0] if name == "mixed_gaussian" else ttrain.cgan1d_task()[1][0]
    jargs, targs = ((jnp.asarray(z),), (torch.from_numpy(z),))
    if name == "timeseries_cgan":
        jargs, targs = jargs + (jnp.asarray(y),), targs + (torch.from_numpy(y),)
    js = jevals.EvalSuite(real=real, sample_fake=lambda gp, r, k: jG.apply(gp, *jargs),
                          modes=jsuite.modes, kind=jsuite.kind)
    ts = tevals.EvalSuite(real=torch.from_numpy(real),
                          sample_fake=lambda gp, g, k: tG.apply(gp, *targs),
                          modes=tsuite.modes, kind=tsuite.kind)
    key = jax.random.key(6)
    w1, w2 = _jax_projection(jax.random.split(key)[1], int(np.prod(real.shape[1:])))
    monkeypatch.setattr(tfd, "random_feature_fn", lambda gen, in_dim, feat_dim=64:
                        tfd.random_features(torch.from_numpy(w1), torch.from_numpy(w2)))
    want = jevals.evaluate(js, jres.fed, jres.state, key, n=n)
    got = tevals.evaluate(ts, tspec.build(), tstate, torch.Generator(), n=n)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_eval_hook_scores_the_intermediary_each_round():
    spec, suite = ttrain.experiment_spec("toy_2d", K=2, steps=6, eval_every=1,
                                         log_every=0, device="cpu")
    result = spec.run_result()
    assert [e["round"] for e in result.evals] == [0, 1, 2]
    assert all(np.isfinite(e["fd"]) for e in result.evals)
    again = tevals.final_fd(suite, result.fed, result.state, seed=0, n=256)
    assert again == tevals.final_fd(suite, result.fed, result.state, seed=0, n=256)
    bad = tevals.EvalSuite(real=suite.real, sample_fake=lambda gp, g, n: torch.full((n,), float("nan")))
    assert tevals.evaluate(bad, result.fed, result.state, torch.Generator()) == \
        {"fd": float("inf"), "nonfinite": 1.0}


def test_run_sweep_writes_the_reference_rows(tmp_path):
    """``run_sweep`` end to end at tiny steps, uncompressed and int8: the
    JSONL rows carry the reference's keys, row by row, and the summary
    table and sweep parsing are the reference's."""
    kw = dict(codec_names=("none", "int8"), steps=4, eval_every=1, eval_n=64, verbose=False)
    cells = texperiments.run_sweep("toy_2d", [2], out_dir=str(tmp_path / "t"),
                                   device="cpu", **kw)
    jcells = jexperiments.run_sweep("toy_2d", [2], out_dir=str(tmp_path / "j"),
                                    rounds_per_chunk=1, **kw)
    rows = [json.loads(l) for l in open(tmp_path / "t" / "sweep_toy_2d.jsonl")]
    jrows = [json.loads(l) for l in open(tmp_path / "j" / "sweep_toy_2d.jsonl")]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    assert [c.label for c in cells] == [c.label for c in jcells] == ["fedgan", "fedgan+int8"]
    for c, jc in zip(cells, jcells):
        assert c.bytes_per_round == jc.bytes_per_round
        assert np.isfinite(c.final["fd"])
    for c in cells:   # the same final numbers in both tables' layouts
        c.final = {"fd": 1.5}
    for c in jcells:
        c.final = {"fd": 1.5}
    assert texperiments.summary_table(cells) == jexperiments.summary_table(jcells)
    for arg in ("K=10,20,100", "5,50"):
        assert texperiments.parse_sweep(arg) == jexperiments.parse_sweep(arg)
    for bad in ("K=", "K=0,5", "K=a"):
        with pytest.raises(ValueError):
            texperiments.parse_sweep(bad)


def test_sweep_refuses_what_is_not_ported(tmp_path):
    """The sweep's cells: (strategy, dp) pairs, the privacy axis ported;
    an unknown strategy or privacy axis raises."""
    strat, dp = texperiments._strategy_for("fedgan", privacy="dp")
    assert strat is None and dp.noise_multiplier == 0.8
    with pytest.raises(ValueError, match="unknown strategy"):
        texperiments._strategy_for("krum")
    with pytest.raises(ValueError, match="unknown privacy axis"):
        texperiments._strategy_for("fedgan", privacy="krum")
    assert texperiments._strategy_for("median")[0].name == "median"
    assert texperiments._strategy_for("distributed")[0].name == "distributed"
    assert texperiments._strategy_for("fedgan") == (None, None)
    assert texperiments._strategy_for("fedgan", "int8")[0].codec.bits == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texperiments.main(["--sweep", "K=2", "--steps", "2", "--out-dir", str(tmp_path)])
    cells = texperiments.main(["--sweep", "K=2", "--steps", "2", "--eval-n", "32",
                               "--out-dir", str(tmp_path), "--device", "cpu"])
    assert len(cells) == 1 and (tmp_path / "sweep_toy_2d.jsonl").exists()


def test_quickstart_converges_on_the_cpu():
    """The port's quickstart at its own defaults (B = 5, K = 20, 3,000 SGD
    steps) reaches (theta, psi) within 0.1 of (1, 0)."""
    out = quickstart.run(device="cpu", verbose=False)
    assert out["rounds"] == 150 and len(out["trajectory"]) == 10
    assert out["trajectory"][-1][0] == 3000
    assert quickstart.converged(out), out["trajectory"]
