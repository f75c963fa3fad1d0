"""The port's privacy and robustness axis against the JAX reference, on the
CPU: a twin of each test of ``tests/test_privacy.py``, parity tests that
take the same numpy inputs through both packages, and planted faults that
the checks must catch.

* Robust reduces: the coordinate median bit for bit (a stable sort, NaN
  last, as ``jnp.sort``); the trimmed mean within (B - 2·trim - 1) float32
  roundings of the sum of the kept |values| over their count, plus one
  rounding of the result (``collectives.make_robust_reduce``).
* The secure sum: the tensor Threefry, the pairwise masks, the wire image
  and ``masked_sync``'s output bit for bit; the secure round bit for bit
  the port's plain round.
* DP-SGD: ``DPSGD.epsilon`` and the accountant bit for bit; clip-only
  per-example gradients of the quadratic task and of the 8x8 ACGAN nets
  within 1e-5 of each leaf's magnitude (batch norm over one example);
  clip-only DP rounds within ``torch_shared.assert_round_close``'s SGD
  bound.  The noise is the port's own draw (ROADMAP §3), so its tests are
  the port's: reproducible from the generator, distinct across agents,
  of std sigma·C/n.
* Rounds of the quadratic task (SGD at 0.05, K = 4, batches of 8) under
  attack, against the reference's: within 1e-5 of each leaf's magnitude.

The jaxpr-size test of the reference has no torch counterpart; its twin
records every tensor the mask accumulator makes (a dispatch mode) and
holds the largest to O(B·leaf).
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from torch_shared import (_assert_tree_close, _strategy_pair, assert_round_close,  # noqa: F401
                          one_torch_thread)

from repro import privacy as jprivacy
from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig, GANTask as JTask
from repro.core import strategies as jstrat
from repro.dist import collectives as jcoll
from repro.optim import SGD as JSGD, constant as jconst, equal_timescale as jequal

from repro_torch import prng
from repro_torch.convert import from_jax_params
from repro_torch.core import FedGAN, FedGANConfig, GANTask
from repro_torch.core import strategies as tstrat
from repro_torch.core.strategies import (CoordinateMedianSync, FedAvgSync, LocalOnly,
                                         SubsampledFedAvg, TrimmedMeanSync)
from repro_torch.dist import collectives
from repro_torch.optim import SGD, clip_by_global_norm, constant, equal_timescale, global_norm
from repro_torch.privacy import (DPSGD, SecureAgg, WithByzantine, accountant, corrupt,
                                 dp_grads, noise_like, per_example_grads)
from repro_torch.privacy import dpsgd as tdpsgd
from repro_torch.tree import tree_leaves, tree_map

LR, K = 0.05, 4


# ---------------------------------------------------------------------------
# the quadratic task of the reference's suite, in both packages
# ---------------------------------------------------------------------------


def jquad_task():
    def init(rng):
        kg, kd = jax.random.split(rng)
        return {"gen": {"theta": 0.1 * jax.random.normal(kg, (3,))},
                "disc": {"w": 0.1 * jax.random.normal(kd, (3,))}}

    def disc_loss(params, batch, rng):
        xm = jnp.mean(batch["x"], axis=0)
        g = jax.lax.stop_gradient(params["gen"]["theta"])
        return (-jnp.dot(params["disc"]["w"], xm - g)
                + 0.5 * jnp.sum(params["disc"]["w"] ** 2))

    def gen_loss(params, batch, rng):
        w = jax.lax.stop_gradient(params["disc"]["w"])
        return jnp.dot(w, params["gen"]["theta"])

    return JTask(init=init, disc_loss=disc_loss, gen_loss=gen_loss)


def tquad_task():
    def init(gen):
        return {"gen": {"theta": 0.1 * torch.randn(3, generator=gen)},
                "disc": {"w": 0.1 * torch.randn(3, generator=gen)}}

    def disc_loss(params, batch):
        xm = torch.mean(batch["x"], dim=0)
        g = params["gen"]["theta"].detach()
        w = params["disc"]["w"]
        return -torch.dot(w, xm - g) + 0.5 * torch.sum(w ** 2)

    def gen_loss(params, batch):
        return torch.dot(params["disc"]["w"].detach(), params["gen"]["theta"])

    return GANTask(init=init, disc_loss=disc_loss, gen_loss=gen_loss)


def _fed(strategy=None, K=K, grid=(1, 4), dp=None):
    return FedGAN(tquad_task(), FedGANConfig(agent_grid=grid, sync_interval=K,
                                             strategy=strategy, dp=dp),
                  opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(LR)))


def _jfed(strategy=None, K=K, grid=(1, 4), dp=None):
    return JFedGAN(jquad_task(), JConfig(agent_grid=grid, sync_interval=K,
                                         strategy=strategy, dp=dp),
                   opt_g=JSGD(), opt_d=JSGD(), scales=jequal(jconst(LR)))


def _xs(grid, r, K=K):
    """Round r's (K, P, A, 8, 3) numpy batch: agent i's data centred at i."""
    P, A = grid
    rng = np.random.default_rng(1 + r)
    return (rng.standard_normal((K, P, A, 8, 3))
            + np.arange(P * A, dtype=np.float32).reshape(P, A)[None, :, :, None, None]
            ).astype(np.float32)


def _start(grid=(1, 4)):
    """The reference's initial state (key 0) in both packages."""
    jstate = _jfed(grid=grid).init_state(jax.random.key(0))
    return jstate, from_jax_params(jax.device_get(jstate), device="cpu")


def _run_rounds(fed, n_rounds=2, state=None, seed=0):
    """The port's rounds on ``_xs``; DP noise from a generator seeded
    ``seed``."""
    K_ = fed.cfg.sync_interval
    if state is None:
        state = _start(fed.cfg.agent_grid)[1]
    gen = torch.Generator().manual_seed(seed)
    for r in range(n_rounds):
        state, metrics = fed.round(state, {"x": torch.from_numpy(_xs(fed.cfg.agent_grid, r, K_))},
                                   gen)
    return state, metrics


def _jrun_rounds(jfed, n_rounds=2, state=None):
    grid, K_ = jfed.cfg.agent_grid, jfed.cfg.sync_interval
    if state is None:
        state = _start(grid)[0]
    seeds = jnp.zeros((K_,) + grid, jnp.uint32)
    for r in range(n_rounds):
        state, metrics = jax.jit(jfed.round)(state, {"x": jnp.asarray(_xs(grid, r, K_))}, seeds)
    return state, metrics


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x.contiguous().view(torch.uint8) if x.is_floating_point() else x,
                           y.contiguous().view(torch.uint8) if y.is_floating_point() else y)
               for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# robust reduces: the statistics themselves
# ---------------------------------------------------------------------------


def _trimmed_bound(x, trim):
    """The trimmed mean's bound against another grouping of its sum: (n -
    1) roundings of sum |kept| / n plus one rounding of the result, n = B -
    2·trim, from the sorted values."""
    B = x.shape[0] * x.shape[1]
    kept = np.sort(x.reshape((B,) + x.shape[2:]), axis=0)[trim:B - trim]
    n = B - 2 * trim
    mag = np.nansum(np.abs(kept), axis=0) / n
    return (n - 1) * 2.0 ** -24 * mag + 2.0 ** -24 * np.abs(np.nansum(kept, axis=0) / n)


@pytest.mark.parametrize("grid", [(2, 3), (1, 5), (1, 4), (2, 4)])
@pytest.mark.parametrize("nan", [False, True])
def test_robust_reduces_match_jax(grid, nan):
    """The median bit for bit, the trimmed mean within its bound, with a
    NaN agent (sorted last, trimmed) and a -0/+0 pair (stable order)."""
    rng = np.random.default_rng(sum(grid) + nan)
    x = rng.standard_normal(grid + (5, 7)).astype(np.float32)
    x[0, 0, 2, 3], x[-1, -1, 2, 3] = -0.0, 0.0
    if nan:
        x[0, 1 % grid[1]] = np.nan
    w = np.full(grid, 1.0 / np.prod(grid), np.float32)
    for kind in ("median", "trimmed_mean"):
        want = np.asarray(jcoll.make_robust_reduce(kind)(jnp.asarray(x), jnp.asarray(w)))
        got = collectives.make_robust_reduce(kind)(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        if kind == "median":
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:
            assert np.all(np.abs(got - want) <= _trimmed_bound(x, 1)), np.abs(got - want).max()
            assert np.isfinite(got).all()


def test_trimmed_mean_and_median_match_numpy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    w = torch.full((2, 3), 1 / 6.0)
    srt = np.sort(x.reshape(6, 5, 7), axis=0)
    tm = collectives.make_robust_reduce("trimmed_mean", trim=1)(torch.from_numpy(x), w)
    np.testing.assert_allclose(tm.numpy(), srt[1:-1].mean(axis=0), rtol=0, atol=1e-6)
    med = collectives.make_robust_reduce("median")(torch.from_numpy(x), w)
    np.testing.assert_array_equal(med.numpy(), srt[(6 - 1) // 2])


@settings(max_examples=10, deadline=None)
@given(perm=st.permutations(list(range(6))), seed=st.integers(0, 50))
def test_robust_reduces_are_permutation_invariant(perm, seed):
    """Order statistics cannot depend on which slot an agent occupies."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, 6, 4)).astype(np.float32))
    w = torch.full((1, 6), 1 / 6.0)
    xp = x[:, torch.tensor(perm)]
    for kind in ("trimmed_mean", "median"):
        r = collectives.make_robust_reduce(kind)
        assert torch.equal(r(x, w), r(xp, w))


def test_robust_reduce_is_weight_oblivious():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 3)).astype(np.float32))
    w_uni = torch.full((1, 4), 0.25)
    w_skew = torch.tensor([[0.97, 0.01, 0.01, 0.01]])
    for kind in ("trimmed_mean", "median"):
        r = collectives.make_robust_reduce(kind)
        assert torch.equal(r(x, w_uni), r(x, w_skew))


def test_robust_reduce_validation():
    with pytest.raises(ValueError, match="unknown robust reduce"):
        collectives.make_robust_reduce("krum")
    with pytest.raises(ValueError, match="2\\*trim"):
        collectives.make_robust_reduce("trimmed_mean", trim=2)(torch.ones((1, 4, 2)),
                                                               torch.full((1, 4), 0.25))


# ---------------------------------------------------------------------------
# attack simulation: planted Byzantine agents in real rounds
# ---------------------------------------------------------------------------


def test_corrupt_touches_only_the_first_f_agents():
    tree = {"p": torch.ones((1, 4, 3)), "n": torch.arange(4).reshape(1, 4)}
    out = corrupt(tree, attack="scale", num_byzantine=2, scale=-5.0)
    got = out["p"].reshape(4, 3)
    assert (got[:2] == -5.0).all() and (got[2:] == 1.0).all()
    assert torch.equal(out["n"], tree["n"])    # integer leaves pass
    for attack in ("sign_flip", "scale", "nan"):
        x = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(np.float32)
        want = jprivacy.corrupt({"p": jnp.asarray(x)}, attack=attack, num_byzantine=4)["p"]
        got = corrupt({"p": torch.from_numpy(x)}, attack=attack, num_byzantine=4)["p"]
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _honest_envelope(local, sub, key, f=1):
    vals = local["params"][sub][key].reshape(-1, 3)[f:].numpy()
    return vals.min(axis=0), vals.max(axis=0)


def check_robust_in_envelope(local, robust, f=1):
    """Every synced value of ``robust`` finite and inside the honest agents'
    per-coordinate envelope of the local-only run (agents f.. honest)."""
    for sub in ("gen", "disc"):
        for key in local["params"][sub]:
            lo, hi = _honest_envelope(local, sub, key, f)
            got = robust["params"][sub][key][0, 0].numpy()
            assert np.isfinite(got).all(), (sub, key, got)
            assert (got >= lo - 1e-6).all() and (got <= hi + 1e-6).all(), (sub, key, got, lo, hi)


@pytest.mark.parametrize("attack", ["sign_flip", "scale", "nan"])
def test_robust_syncs_stay_in_honest_envelope_fedavg_does_not(attack):
    """One planted attacker (f = 1, B = 6): the trimmed-mean and median
    syncs land inside the honest envelope; plain FedAvg is dragged out by a
    x100 attacker, to NaN by a NaN-emitter, off its attacker-free answer by
    a sign-flipper."""
    grid = (1, 6)
    local, _ = _run_rounds(_fed(LocalOnly(), grid=grid), n_rounds=1)
    clean, _ = _run_rounds(_fed(FedAvgSync(), grid=grid), n_rounds=1)

    def synced(strategy):
        return _run_rounds(_fed(WithByzantine(strategy, attack=attack), grid=grid),
                           n_rounds=1)[0]

    avg = synced(FedAvgSync())
    for robust in (TrimmedMeanSync(), CoordinateMedianSync()):
        check_robust_in_envelope(local, synced(robust))
    for sub in ("gen", "disc"):
        for key in local["params"][sub]:
            lo, hi = _honest_envelope(local, sub, key)
            bad = avg["params"][sub][key][0, 0].numpy()
            if attack == "nan":
                assert np.isnan(bad).all()
            elif attack == "scale":
                assert ((bad < lo - 1e-6) | (bad > hi + 1e-6)).any()
            else:
                ref = clean["params"][sub][key][0, 0].numpy()
                assert np.abs(bad - ref).max() > 1e-4


def test_planted_torch_median_fails_the_envelope_check_under_nan(monkeypatch):
    """A planted fault: ``torch.median`` in place of the sorted lower
    median.  Without NaN the two agree (both take the lower middle), but
    ``torch.median`` returns NaN where any agent is NaN, so under the
    ``nan`` attack the envelope check must fail."""
    grid = (1, 6)
    local, _ = _run_rounds(_fed(LocalOnly(), grid=grid), n_rounds=1)
    real = collectives.make_robust_reduce

    def planted(kind, **kw):
        if kind != "median":
            return real(kind, **kw)
        return lambda x, w: torch.median(x.reshape((-1,) + tuple(x.shape[2:])), dim=0).values

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 6, 9)).astype(np.float32))
    assert torch.equal(planted("median")(x, None), real("median")(x, None))
    monkeypatch.setattr(collectives, "make_robust_reduce", planted)
    synced, _ = _run_rounds(_fed(WithByzantine(CoordinateMedianSync(), attack="nan"), grid=grid),
                            n_rounds=1)
    with pytest.raises(AssertionError):
        check_robust_in_envelope(local, synced)


ROBUST_CASES = {
    "trimmed_mean": (jstrat.TrimmedMeanSync(), TrimmedMeanSync()),
    "median": (jstrat.CoordinateMedianSync(), CoordinateMedianSync()),
    "fedgan": (jstrat.FedAvgSync(), FedAvgSync()),
}


@pytest.mark.parametrize("attack", ["sign_flip", "scale", "nan"])
@pytest.mark.parametrize("case", sorted(ROBUST_CASES))
def test_attacked_rounds_match_jax(case, attack):
    """Two rounds of the quadratic task on a (1, 6) grid under one attacker
    against the reference's: within 1e-5 of each leaf's magnitude (NaN
    where the reference is NaN)."""
    jstrategy, tstrategy = ROBUST_CASES[case]
    grid = (1, 6)
    want, _ = _jrun_rounds(_jfed(jprivacy.WithByzantine(jstrategy, attack=attack), grid=grid))
    got, _ = _run_rounds(_fed(WithByzantine(tstrategy, attack=attack), grid=grid))
    _assert_tree_close(got["params"], want["params"])


def test_robust_sync_close_to_attacker_free_average():
    grid = (1, 6)
    local, _ = _run_rounds(_fed(LocalOnly(), grid=grid), n_rounds=1)
    clean, _ = _run_rounds(_fed(FedAvgSync(), grid=grid), n_rounds=1)
    atk_avg, _ = _run_rounds(_fed(WithByzantine(FedAvgSync(), attack="scale"), grid=grid),
                             n_rounds=1)
    atk_tm, _ = _run_rounds(_fed(WithByzantine(TrimmedMeanSync(), attack="scale"), grid=grid),
                            n_rounds=1)
    for sub in ("gen", "disc"):
        for key in clean["params"][sub]:
            ref = clean["params"][sub][key][0, 0].numpy()
            spread = np.ptp(local["params"][sub][key].reshape(-1, 3).numpy(), axis=0).max()
            err_tm = np.abs(atk_tm["params"][sub][key][0, 0].numpy() - ref).max()
            err_avg = np.abs(atk_avg["params"][sub][key][0, 0].numpy() - ref).max()
            assert err_tm <= spread + 1e-6, (sub, key, err_tm, spread)
            assert err_avg > 10 * max(err_tm, 1e-6), (sub, key, err_avg, err_tm)


def test_breakdown_points():
    """f = trim + 1 attackers defeat the trimmed mean; f >= B/2 the
    median."""
    w = torch.full((1, 6), 1 / 6.0)
    honest = (torch.arange(6, dtype=torch.float32)[None, :, None] * 0.1).expand(1, 6, 3)

    def attacked(f, scale=-1e4):
        flat = honest.reshape(6, 3)
        return torch.where((torch.arange(6) < f)[:, None], torch.tensor(scale), flat).reshape(1, 6, 3)

    tm = collectives.make_robust_reduce("trimmed_mean", trim=1)
    med = collectives.make_robust_reduce("median")
    lo, hi = float(honest.min()), float(honest.max())
    assert lo <= float(tm(attacked(1), w).min()) <= hi
    assert lo <= float(med(attacked(2), w).min()) <= hi
    assert float(tm(attacked(2), w).min()) < lo - 1.0
    assert float(med(attacked(3), w).min()) < lo - 1.0


def test_trimmed_mean_validate_and_byzantine_wrapper_validate():
    cfg4 = FedGANConfig(agent_grid=(1, 4), sync_interval=4)
    with pytest.raises(ValueError, match="trim must be"):
        TrimmedMeanSync(trim=0).validate(cfg4)
    with pytest.raises(ValueError, match="num_agents > 2\\*trim"):
        TrimmedMeanSync(trim=2).validate(cfg4)
    TrimmedMeanSync(trim=1).validate(cfg4)
    with pytest.raises(ValueError, match="unknown attack"):
        WithByzantine(FedAvgSync(), attack="mimic").validate(cfg4)
    with pytest.raises(ValueError, match="num_byzantine"):
        WithByzantine(FedAvgSync(), num_byzantine=5).validate(cfg4)
    # a robust reduce cannot ride the fused kernel
    from repro_torch.comm import IntQuant
    with pytest.raises(ValueError, match="robust reduce"):
        TrimmedMeanSync(codec=IntQuant(8), fused_sync=True).validate(cfg4)


@pytest.mark.parametrize("codec", ["int8", "topk+int4"])
@pytest.mark.parametrize("kind", ["trimmed_mean", "median"])
def test_robust_coded_sync_matches_jax(kind, codec):
    """The composed coded sync with a robust reduce on the decoded wire
    images, against the reference's on the same leaves and residuals:
    the synced values and both residuals within 1e-6 of the leaf's
    magnitude (the trimmed mean's bound, carried through the downlink
    encode) but on at most 2% of the elements, where a value within
    rounding of a tie may take the neighbouring code: there within two
    quanta of the coarsest block.  The median, an order statistic, departs
    only at such ties."""
    from repro.comm import get_codec as jget
    from repro_torch.comm import get_codec as tget
    rng = np.random.default_rng(3)
    grid = (1, 5)
    tree = {"a": rng.standard_normal(grid + (300,)).astype(np.float32),
            "b": rng.standard_normal(grid + (4, 70)).astype(np.float32)}
    ef = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in tree.items()}
    efd = {k: (0.01 * rng.standard_normal(v.shape[2:])).astype(np.float32)
           for k, v in tree.items()}
    w = np.full(grid, 0.2, np.float32)
    kw = {"fraction": 0.25} if "topk" in codec else {}
    js, je, jd = jcoll.coded_sync({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(w),
                                  jget(codec, **kw), ef={k: jnp.asarray(v) for k, v in ef.items()},
                                  ef_down={k: jnp.asarray(v) for k, v in efd.items()},
                                  reduce=jcoll.make_robust_reduce(kind))
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    ts, te, td = collectives.coded_sync(t(tree), torch.from_numpy(w), tget(codec, **kw),
                                        ef=t(ef), ef_down=t(efd),
                                        reduce=collectives.make_robust_reduce(kind))
    for k in tree:
        q = 1.01 * float(np.abs(tree[k] + ef[k]).max()) / (127 if codec == "int8" else 7)
        for got, want in ((ts[k], js[k]), (te[k], je[k]), (td[k], jd[k])):
            diff = np.abs(got.numpy() - np.asarray(want))
            assert (diff <= 2 * q).all(), (k, float(diff.max()))
            tight = 1e-6 * max(1.0, float(np.abs(tree[k]).max()))
            assert (diff > tight).mean() <= 0.02, (k, float((diff > tight).mean()))
            if kind == "median":
                assert (diff > 0).mean() <= 0.02, (k, float((diff > 0).mean()))
    with pytest.raises(ValueError, match="custom reduce"):
        collectives.coded_sync(t(tree), torch.from_numpy(w), tget("int8"), fused=True,
                               reduce=collectives.make_robust_reduce(kind))


# ---------------------------------------------------------------------------
# DP-SGD: clipping, noise, accountant
# ---------------------------------------------------------------------------


def test_clip_by_global_norm_zero_grads_pass_through_exactly():
    """At norm 0 the scale is exactly 1.0, and the tangent through the clip
    finite (the gradient is NaN, as in the reference: ROADMAP §3)."""
    grads = {"a": torch.zeros((3, 4)), "b": torch.zeros((7,))}
    clipped, norm = clip_by_global_norm(grads, 0.5)
    assert float(norm) == 0.0
    for leaf in tree_leaves(clipped):
        assert (leaf == 0).all()
    f = lambda g: clip_by_global_norm(g, 0.5)[0]  # noqa: E731
    tangents = torch.func.jvp(f, (grads,), ({"a": torch.ones((3, 4)), "b": torch.ones((7,))},))[1]
    for leaf in tree_leaves(tangents):
        assert torch.isfinite(leaf).all()


@pytest.mark.parametrize("max_norm", [0.37, 1.0, 3.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The scale is max_norm / norm, divided, as the reference divides (a
    Python number over a tensor would multiply by the reciprocal): each
    clipped leaf is the leaf times exactly that quotient.  The norm's sums
    group otherwise than the reference's: within 2 float32 ulps of it,
    and the clipped leaves within 4 of theirs."""
    from repro.optim import clip_by_global_norm as jclip
    rng = np.random.default_rng(int(max_norm * 100))
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    want, wn = jclip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, gn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    assert abs(float(gn) - float(wn)) <= 2 * np.spacing(np.float32(wn))
    scale = torch.clamp(torch.tensor(max_norm, dtype=torch.float32) / gn, max=1.0)
    for k in g:
        assert torch.equal(got[k], torch.from_numpy(g[k]) * scale)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=4 * 2.0 ** -23,
                                   atol=0)
    # over a thousand norms (the reciprocal's product differs on about a
    # quarter of them)
    gs = torch.from_numpy(rng.uniform(0, 10, (1000, 5)).astype(np.float32))
    clipped, norms = torch.func.vmap(lambda v: clip_by_global_norm({"a": v}, max_norm))(gs)
    scales = torch.clamp(torch.full_like(norms, max_norm) / norms, max=1.0)
    assert torch.equal(clipped["a"], gs * scales[:, None])


def _agent_params(grid=(1, 4)):
    jstate, tstate = _start(grid)
    return (jax.tree_util.tree_map(lambda x: x[0, 0], jstate["params"]),
            tree_map(lambda x: x[0, 0], tstate["params"]))


def check_joint_clip(per_example, fed, params, batch, C):
    """Each example's joint (G, D) gradient has norm <= C, and = C where
    its pre-clip joint norm exceeds C (a per-player clip leaves up to
    sqrt(2)·C)."""
    gd, gg, nd, ng, _ = per_example(fed._agent_grads, params, batch, C)
    for i in range(batch["x"].shape[0]):
        joint = (tree_map(lambda v: v[i], gd), tree_map(lambda v: v[i], gg))
        jn = float(global_norm(joint))
        assert jn <= C * (1 + 1e-6), (i, jn)
        if math.hypot(float(nd[i]), float(ng[i])) > C:
            assert jn == pytest.approx(C, rel=1e-5), (i, jn)


def test_per_example_grads_clipped_to_c_exactly():
    fed = _fed()
    _, params = _agent_params()
    batch = {"x": 50.0 * torch.from_numpy(np.random.default_rng(1).standard_normal((8, 3))
                                          .astype(np.float32))}
    C = 0.37
    gd, gg, nd, ng, _ = per_example_grads(fed._agent_grads, params, batch, C)
    for i in range(8):
        for g in (tree_map(lambda v: v[i], gd), tree_map(lambda v: v[i], gg)):
            assert float(global_norm(g)) <= C * (1 + 1e-6)
    assert float(nd.max()) > C   # pre-clip norms are reported un-clipped


def test_per_example_joint_grad_clipped_to_c_exactly():
    fed = _fed()
    _, params = _agent_params()
    batch = {"x": 50.0 * torch.from_numpy(np.random.default_rng(1).standard_normal((8, 3))
                                          .astype(np.float32))}
    check_joint_clip(per_example_grads, fed, params, batch, 0.37)


def _per_player_clip(grad_fn, params, batch, clip):
    """A planted fault: each player clipped to C on its own (joint
    sensitivity sqrt(2)·C)."""
    def one(ex):
        gd, gg, m = grad_fn(params, tree_map(lambda v: v[None], ex))
        nd, ng = global_norm(gd), global_norm(gg)
        return clip_by_global_norm(gd, clip)[0], clip_by_global_norm(gg, clip)[0], nd, ng, m
    return torch.func.vmap(one)(batch)


def test_planted_per_player_clip_fails_the_joint_clip_check():
    fed = _fed()
    _, params = _agent_params()
    batch = {"x": 50.0 * torch.from_numpy(np.random.default_rng(1).standard_normal((8, 3))
                                          .astype(np.float32))}
    with pytest.raises(AssertionError):
        check_joint_clip(_per_player_clip, fed, params, batch, 0.37)


@pytest.mark.parametrize("C", [0.37, 5.0])
def test_per_example_grads_match_jax_quad(C):
    fed, jfed = _fed(), _jfed()
    jp, tp = _agent_params()
    x = (50.0 * np.random.default_rng(1).standard_normal((8, 3))).astype(np.float32)
    want = jprivacy.per_example_grads(jfed._local_grads, jp, {"x": jnp.asarray(x)},
                                      jax.random.key(2), C)
    got = per_example_grads(fed._agent_grads, tp, {"x": torch.from_numpy(x)}, C)
    for g, w in zip(got[:4], want[:4]):
        _assert_tree_close(g, w)


def _acgan_dp_pair(dp_pair, grid=(1, 5), k=2):
    jfed, tfed, lr = _strategy_pair("sgd", None, None, hw=8, grid=grid, k=k)
    jfed = dataclasses.replace(jfed, cfg=dataclasses.replace(jfed.cfg, dp=dp_pair[0]))
    tfed = dataclasses.replace(tfed, cfg=dataclasses.replace(tfed.cfg, dp=dp_pair[1]))
    return jfed, tfed, lr


def _acgan_batch(rng, lead):
    return {"x": rng.uniform(-1, 1, lead + (8, 8, 3)).astype(np.float32),
            "y": rng.integers(0, 10, lead).astype(np.int32),
            "z": rng.standard_normal(lead + (62,)).astype(np.float32)}


@pytest.mark.parametrize("C", [0.5, 1e3])
def test_per_example_grads_match_jax_acgan(C):
    """The 8x8 ACGAN nets: every batch norm sees one example (variance 0,
    output its shift), and the discriminator's leaky ReLU takes that shift
    at exactly 0, where the gradient is 1 as in the reference."""
    jfed, tfed, _ = _acgan_dp_pair((None, None))
    jstate = jfed.init_state(jax.random.key(0))
    jp = jax.tree_util.tree_map(lambda x: x[0, 0], jstate["params"])
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    batch = _acgan_batch(np.random.default_rng(1), (6,))
    want = jprivacy.per_example_grads(jfed._local_grads, jp,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.key(2), C)
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        got = per_example_grads(tfed._agent_grads, tp,
                                {k: torch.from_numpy(v) for k, v in batch.items()}, C)
    assert float(torch.max(torch.hypot(got[2], got[3]))) > 0
    for g, w in zip(got[:4], want[:4]):
        _assert_tree_close(g, w)


@pytest.mark.parametrize("task", ["quad", "toy_2d", "acgan"])
def test_clip_only_dp_round_matches_jax(task):
    """A clip-only DP-SGD round (sigma = 0) against the reference's, within
    ``assert_round_close``'s SGD bound; the DP metrics the reference's."""
    if task == "quad":
        jfed, tfed = _jfed(dp=jprivacy.DPSGD(clip=0.5)), _fed(dp=DPSGD(clip=0.5))
        jstate, start = _start()
        batches = {"x": _xs((1, 4), 0)}
        lr = LR
    elif task == "toy_2d":
        from repro.launch.train import toy2d_task as jtoy
        from repro_torch.launch.train import toy2d_task as ttoy
        grid, lr = (1, 5), 0.05
        jfed = JFedGAN(jtoy()[0], JConfig(agent_grid=grid, sync_interval=2,
                                          dp=jprivacy.DPSGD(clip=0.05)),
                       opt_g=JSGD(), opt_d=JSGD(), scales=jequal(jconst(lr)))
        tfed = FedGAN(ttoy()[0], FedGANConfig(agent_grid=grid, sync_interval=2,
                                              dp=DPSGD(clip=0.05)),
                      opt_g=SGD(), opt_d=SGD(), scales=equal_timescale(constant(lr)))
        jstate = jfed.init_state(jax.random.key(0))
        start = from_jax_params(jax.device_get(jstate), device="cpu")
        rng = np.random.default_rng(5)
        batches = {k: rng.uniform(-1, 1, (2,) + grid + (8,)).astype(np.float32)
                   for k in ("x", "z")}
    else:
        jfed, tfed, lr = _acgan_dp_pair((jprivacy.DPSGD(clip=0.5), DPSGD(clip=0.5)))
        jstate = jfed.init_state(jax.random.key(0))
        start = from_jax_params(jax.device_get(jstate), device="cpu")
        batches = _acgan_batch(np.random.default_rng(2), (2, 1, 5, 6))
    K_ = tfed.cfg.sync_interval
    seeds = jnp.zeros((K_,) + tfed.cfg.agent_grid, jnp.uint32)
    want, wm = jax.jit(jfed.round)(jstate, {k: jnp.asarray(v) for k, v in batches.items()}, seeds)
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        got, gm = tfed.round(start, {k: torch.from_numpy(v) for k, v in batches.items()})
    assert sorted(gm) == sorted(wm)
    assert float(gm["dp_grad_norm_d"].max()) > tfed.cfg.dp.clip   # the clip binds
    for k in ("dp_grad_norm_d", "dp_grad_norm_g"):
        np.testing.assert_allclose(gm[k].numpy(), np.asarray(wm[k]), rtol=1e-5)
    if task != "acgan":
        _assert_tree_close(got["params"], want["params"])
    else:
        assert_round_close(tfed, start, {k: torch.from_numpy(v) for k, v in batches.items()},
                           got, jax.device_get(want), "sgd", lr, False)


def test_dp_noise_bit_reproducible_and_distinct_across_agents():
    """The same generator state gives the same noise; another state,
    another; every agent its own; and the noise moved the gradient."""
    dp = DPSGD(clip=1.0, noise_multiplier=1.0)
    fed = _fed(dp=dp)
    _, params = _agent_params()
    batch = {"x": torch.from_numpy(np.random.default_rng(1).standard_normal((4, 3))
                                   .astype(np.float32))}

    def noise(seed):
        g = torch.Generator().manual_seed(seed)
        return noise_like(params["disc"], g), noise_like(params["gen"], g)

    g1 = dp_grads(fed._agent_grads, params, batch, dp, noise(10))
    g2 = dp_grads(fed._agent_grads, params, batch, dp, noise(10))
    g3 = dp_grads(fed._agent_grads, params, batch, dp, noise(11))
    assert _leaves_equal(g1[:2], g2[:2])
    assert not _leaves_equal(g1[:2], g3[:2])
    plain = dp_grads(fed._agent_grads, params, batch, dp)
    assert not _leaves_equal(g1[0], plain[0])
    state = _start()[1]
    z = fed.step_noise(state, torch.Generator().manual_seed(0))
    for leaf in tree_leaves(z):
        flat = leaf.reshape(4, -1)
        assert len({flat[a].numpy().tobytes() for a in range(4)}) == 4


def test_dp_noise_has_the_mechanism_std():
    """sigma·C/n on every coordinate of the mean: the noised gradient less
    the clip-only one, over many draws, within 5% of it."""
    dp = DPSGD(clip=0.5, noise_multiplier=2.0)
    fed = _fed(dp=dp)
    _, params = _agent_params()
    n = 8
    batch = {"x": torch.from_numpy(np.random.default_rng(1).standard_normal((n, 3))
                                   .astype(np.float32))}
    plain = dp_grads(fed._agent_grads, params, batch, dp)
    g = torch.Generator().manual_seed(0)
    diffs = []
    for _ in range(400):
        nz = (noise_like(params["disc"], g), noise_like(params["gen"], g))
        noised = dp_grads(fed._agent_grads, params, batch, dp, nz)
        diffs.append(torch.cat([(a - b).reshape(-1) for a, b in
                                zip(tree_leaves(noised[:2]), tree_leaves(plain[:2]))]))
    std = float(torch.stack(diffs).std())
    assert std == pytest.approx(2.0 * 0.5 / n, rel=0.05)


def test_noise_like_is_leaf_order_stable():
    tree = {"a": torch.zeros((2, 3)), "b": torch.zeros((5,))}
    n1 = noise_like(tree, torch.Generator().manual_seed(3), 1.0)
    n2 = noise_like(tree, torch.Generator().manual_seed(3), 1.0)
    assert _leaves_equal(n1, n2)
    assert not torch.equal(n1["a"], torch.zeros((2, 3)))
    g = torch.Generator().manual_seed(3)   # leaf order: "a" first, then "b"
    first = torch.randn((2, 3), generator=g)
    assert torch.equal(n1["a"], first)


def test_dp_round_runs_finite_and_carries_dp_metrics():
    state, metrics = _run_rounds(_fed(dp=DPSGD(clip=0.5, noise_multiplier=0.5)))
    assert {"dp_grad_norm_d", "dp_grad_norm_g"} <= set(metrics)
    for leaf in tree_leaves(state["params"]):
        assert torch.isfinite(leaf).all()
    _run_rounds(_fed(dp=DPSGD(clip=0.5)))       # clip-only also runs
    assert DPSGD(clip=0.5).epsilon(10) == math.inf
    with pytest.raises(ValueError, match="noise"):   # noise needs its generator
        _fed(dp=DPSGD(noise_multiplier=1.0)).round(_start()[1],
                                                   {"x": torch.from_numpy(_xs((1, 4), 0))})


@pytest.mark.parametrize("sigma,T,delta", [(1.5, 200, 1e-5), (4.0, 1000, 1e-6), (0.8, 50, 1e-5)])
def test_accountant_matches_analytic_gaussian_bound(sigma, T, delta):
    L = math.log(1.0 / delta)
    analytic = T / (2 * sigma ** 2) + math.sqrt(2 * T * L) / sigma
    got = accountant.epsilon(noise_multiplier=sigma, steps=T, delta=delta)
    assert abs(got - analytic) < 1e-6, (got, analytic)
    assert abs(DPSGD(noise_multiplier=sigma, delta=delta).epsilon(T) - analytic) < 1e-6


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.7])
@pytest.mark.parametrize("q", [1.0, 0.5, 0.05, 0.003])
@pytest.mark.parametrize("T", [0, 1, 37, 1000])
def test_epsilon_matches_jax_bit_for_bit(sigma, q, T):
    for delta in (1e-5, 1e-3):
        want = jprivacy.DPSGD(noise_multiplier=sigma, sample_rate=q, delta=delta).epsilon(T)
        got = DPSGD(noise_multiplier=sigma, sample_rate=q, delta=delta).epsilon(T)
        assert got == want or (math.isnan(got) and math.isnan(want)), (got, want)
    for a in (2, 3, 17, 128):
        if sigma:
            assert accountant.rdp_order(a, noise_multiplier=sigma, sample_rate=q) == \
                jprivacy.accountant.rdp_order(a, noise_multiplier=sigma, sample_rate=q)


def test_accountant_monotonicity_and_subsampling_gain():
    e = lambda **kw: accountant.epsilon(delta=1e-5, **kw)  # noqa: E731
    assert e(noise_multiplier=1.0, steps=100) > e(noise_multiplier=2.0, steps=100)
    assert e(noise_multiplier=1.0, steps=400) > e(noise_multiplier=1.0, steps=100)
    assert e(noise_multiplier=1.0, steps=100, sample_rate=0.05) < e(noise_multiplier=1.0,
                                                                    steps=100)


def test_accountant_edges_and_validation():
    assert accountant.epsilon(noise_multiplier=0.0, steps=10) == math.inf
    assert accountant.epsilon(noise_multiplier=1.0, steps=0) == 0.0
    with pytest.raises(ValueError, match="delta"):
        accountant.epsilon(noise_multiplier=1.0, steps=1, delta=2.0)
    with pytest.raises(ValueError, match="order"):
        accountant.rdp_order(1.0, noise_multiplier=1.0)
    with pytest.raises(ValueError, match="integer orders"):
        accountant.rdp_order(2.5, noise_multiplier=1.0, sample_rate=0.5)
    with pytest.raises(ValueError, match="sample_rate"):
        accountant.rdp_order(2, noise_multiplier=1.0, sample_rate=0.0)
    for bad in (DPSGD(clip=0.0), DPSGD(noise_multiplier=-1.0), DPSGD(sample_rate=0.0),
                DPSGD(delta=0.0)):
        with pytest.raises(ValueError):
            bad.validate()
    with pytest.raises(ValueError, match="clip"):
        FedGANConfig(agent_grid=(1, 4), sync_interval=4, dp=DPSGD(clip=-1.0)).validate()


def test_driver_refuses_understated_sample_rate():
    from repro_torch.data import DeviceFederatedData, StreamingFederatedData
    from repro_torch.run.driver import RoundDriver, check_dp_sample_rate
    rng = np.random.default_rng(0)
    agent_data = [{"x": torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32))}
                  for _ in range(4)]
    data = StreamingFederatedData.from_agent_data(agent_data, (1, 4), batch_size=8,
                                                  sync_interval=4, device="cpu")
    bad = _fed(dp=DPSGD(noise_multiplier=1.0, sample_rate=0.1))
    with pytest.raises(ValueError, match="understates"):
        RoundDriver(bad, data, n_rounds=1, log_every=0, verbose=False).run(0)
    ok = _fed(dp=DPSGD(noise_multiplier=1.0, sample_rate=0.5))
    res = RoundDriver(ok, data, n_rounds=1, log_every=0, verbose=False).run(0)
    assert np.isfinite(res.timings["dp_epsilon"])
    assert res.timings["dp_epsilon"] == DPSGD(noise_multiplier=1.0, sample_rate=0.5).epsilon(4)
    dev = DeviceFederatedData.from_agent_data(agent_data, (1, 4), batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="understates"):
        check_dp_sample_rate(DPSGD(sample_rate=0.25), dev)
    check_dp_sample_rate(DPSGD(sample_rate=1.0), dev)


@pytest.mark.parametrize("data_mode,chunk", [("device", 1), ("device", 2), ("stream", 1)])
def test_driver_surfaces_dp_epsilon(data_mode, chunk):
    from repro_torch.launch.train import experiment_spec
    dp = DPSGD(clip=1.0, noise_multiplier=2.0)
    spec, _ = experiment_spec("toy_2d", K=5, steps=10, eval_every=1, log_every=0,
                              data_mode=data_mode, dp=dp, device="cpu", samples_per_agent=256,
                              rounds_per_chunk=chunk)
    res = spec.run_result()
    assert res.evals and all("dp_epsilon" in e for e in res.evals)
    assert res.timings["dp_epsilon"] == pytest.approx(dp.epsilon(10))
    eps = [e["dp_epsilon"] for e in res.evals]
    assert eps == sorted(eps) and eps[0] > 0
    assert all(np.isfinite(v) for m in res.history for v in m.values())


def test_stream_and_device_dp_rounds_draw_their_noise_from_the_round_generator():
    """Two runs from one seed agree bit for bit (the noise is the round
    generator's), and another seed draws other noise."""
    from repro_torch.launch.train import experiment_spec
    dp = DPSGD(clip=1.0, noise_multiplier=1.0)
    out = {}
    for seed in (0, 0, 1):
        spec, _ = experiment_spec("toy_2d", K=2, steps=4, log_every=0, dp=dp, device="cpu",
                                  samples_per_agent=64, seed=0)
        res = dataclasses.replace(spec, seed=seed).run_result()
        out.setdefault(seed, []).append(res.state["params"])
    assert _leaves_equal(out[0][0], out[0][1])
    assert not _leaves_equal(out[0][0], out[1][0])


# ---------------------------------------------------------------------------
# secure summing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5,), (3, 4), (1000,), (2, 3, 7)])
@pytest.mark.parametrize("data", [0, 3, 17, 2 ** 31 - 1])
def test_tensor_threefry_matches_numpy_and_jax(shape, data):
    """``fold_in_t`` and ``random_bits_t`` bit for bit ``prng``'s numpy
    Threefry and ``jax.random``; the folded datum a device int32 tensor."""
    k = prng.key(7)
    kt = prng.fold_in_t(prng.key_t(k, "cpu"), torch.tensor(data, dtype=torch.int32))
    np.testing.assert_array_equal(kt.numpy().astype(np.uint32), prng.fold_in(k, data))
    got = prng.random_bits_t(kt, shape).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, prng.random_bits(prng.fold_in(k, data), shape))
    want = jax.random.bits(jax.random.fold_in(jax.random.key(7), data), shape, jnp.uint32)
    np.testing.assert_array_equal(got, np.asarray(want))


def _tkey(seed, step):
    return collectives.mask_pair_key(prng.key_t(prng.key(seed), "cpu"),
                                     torch.tensor(step, dtype=torch.int32))


def test_masked_sync_bit_identical_to_average_agents():
    rng = np.random.default_rng(1)
    tree = {"a": torch.from_numpy(rng.standard_normal((2, 3, 4, 5)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((2, 3, 7)).astype(np.float32)),
            "count": torch.zeros((2, 3), dtype=torch.int32)}
    w = torch.from_numpy(rng.uniform(size=(2, 3)).astype(np.float32))
    w = w / torch.sum(w)
    plain = collectives.average_agents(tree, w)
    masked = collectives.masked_sync(tree, w, _tkey(0, 17))
    assert _leaves_equal(plain, masked)


@pytest.mark.parametrize("grid", [(2, 3), (1, 5), (1, 2), (3, 1)])
def test_masked_sync_wire_and_output_match_jax(grid):
    """The wire image (the masks drawn from the same key) and the output
    bit for bit the reference's; the output also bit for bit the plain
    average's."""
    rng = np.random.default_rng(sum(grid))
    tree = {"a": rng.standard_normal(grid + (4, 5)).astype(np.float32),
            "count": np.zeros(grid, np.int32),
            "b": rng.standard_normal(grid + (33,)).astype(np.float32)}
    w = rng.uniform(size=grid).astype(np.float32)
    w = w / w.sum()
    jkey = jcoll.mask_pair_key(jax.random.key(5), 9)
    tkey = _tkey(5, 9)
    np.testing.assert_array_equal(tkey.numpy().astype(np.uint32), jax.random.key_data(jkey))
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    want = jcoll.masked_sync(jt, jnp.asarray(w), jkey)
    got = collectives.masked_sync(tt, torch.from_numpy(w), tkey)
    wire = collectives.masked_wire(tt, torch.from_numpy(w), tkey)
    for i, k in enumerate(sorted(tree)):
        if k == "count":
            assert wire[k] is None and torch.equal(got[k], tt[k])
            continue
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        m = jcoll._pairwise_masks(jax.random.fold_in(jkey, i), grid, tree[k].shape[2:])
        jwire = jax.lax.bitcast_convert_type(
            jt[k] * jnp.asarray(w).reshape(grid + (1,) * (tree[k].ndim - 2)), jnp.uint32) + m
        np.testing.assert_array_equal(wire[k].numpy().astype(np.uint32), np.asarray(jwire))
    plain = collectives.average_agents(tt, torch.from_numpy(w))
    assert _leaves_equal(plain, got)


def check_masks_telescope(masks_fn):
    for grid in ((1, 4), (2, 3), (1, 2)):
        m = masks_fn(prng.key_t(prng.key(5), "cpu"), grid, (16,))
        total = m.reshape(-1, 16).sum(0) & 0xFFFFFFFF
        assert (total == 0).all(), (grid, total)


def check_wire_sums_to_payload_sum():
    """What a server that sees only the wire can add: the sum of the wire
    images, mod 2^32, is the sum of the payloads' bits, since the masks
    cancel."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    w = torch.full((2, 3), 1 / 6.0)
    wire = collectives.masked_wire({"p": x}, w, _tkey(1, 4))["p"]
    payload = collectives._to_bits(x * w.reshape(2, 3, 1))
    assert torch.equal(wire.reshape(6, -1).sum(0) & 0xFFFFFFFF,
                       payload.reshape(6, -1).sum(0) & 0xFFFFFFFF)


def test_pairwise_masks_telescope_to_exactly_zero():
    check_masks_telescope(collectives._pairwise_masks)
    check_wire_sums_to_payload_sum()
    for grid in ((1, 4), (2, 3)):   # and they are the reference's masks
        want = jcoll._pairwise_masks(jax.random.key(5), grid, (16,))
        got = collectives._pairwise_masks(prng.key_t(prng.key(5), "cpu"), grid, (16,))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def _one_half_dropped(keys, sizes, B):
    """A planted fault: each pair's mask added to agent i, never taken
    from agent j."""
    acc = torch.zeros((B, sum(sizes)), dtype=torch.int64)
    hi, lo = prng.counters_t(sum(sizes), "cpu")
    p = 0
    for i in range(B):
        for j in range(i + 1, B):
            pk = prng.fold_in_t(keys, p)
            y0, y1 = prng.threefry2x32_t(pk[0, 0], pk[0, 1], hi, lo)
            acc[i] = (acc[i] + (y0 ^ y1)) & 0xFFFFFFFF
            p += 1
    return acc


def test_planted_one_sided_mask_fails_the_telescoping_checks(monkeypatch):
    """With one half of each pair dropped the pads no longer cancel: the
    masks do not telescope and the wire no longer sums to the payload.
    (The simulation's per-agent unmasking still recovers each value, so
    the round alone cannot show it.)"""
    monkeypatch.setattr(collectives, "_accumulate_masks", _one_half_dropped)
    with pytest.raises(AssertionError):
        check_masks_telescope(collectives._pairwise_masks)
    with pytest.raises(AssertionError):
        check_wire_sums_to_payload_sum()


def test_wire_image_hides_plaintext_and_rotates_per_round():
    x = torch.ones((1, 4, 64))
    w = torch.full((1, 4), 1.0)    # unit weights: the payload is x itself
    bits = collectives._to_bits(x)
    wire1 = collectives.masked_wire({"p": x}, w, _tkey(0, 1))["p"]
    wire2 = collectives.masked_wire({"p": x}, w, _tkey(0, 2))["p"]
    assert not torch.equal(wire1, bits)
    assert not torch.equal(wire1, wire2)
    assert len({wire1[0, a].numpy().tobytes() for a in range(4)}) == 4


def test_secure_round_bit_identical_to_plain_round():
    plain, _ = _run_rounds(_fed(FedAvgSync()))
    secure, _ = _run_rounds(_fed(FedAvgSync(secure_agg=SecureAgg())))
    assert _leaves_equal(plain["params"], secure["params"])
    plain, _ = _run_rounds(_fed(FedAvgSync(average_opt_state=True)))
    secure, _ = _run_rounds(_fed(FedAvgSync(average_opt_state=True, secure_agg=SecureAgg())))
    assert _leaves_equal(plain["params"], secure["params"])
    assert _leaves_equal(plain["opt_g"], secure["opt_g"])


def test_secure_round_matches_jax():
    """Two secure rounds of the quadratic task against the reference's:
    within 1e-5 of each leaf's magnitude (the K local steps run compiled
    in the reference), the round keys folded from the same step."""
    want, _ = _jrun_rounds(_jfed(jstrat.FedAvgSync(secure_agg=jprivacy.SecureAgg(seed=3))))
    got, _ = _run_rounds(_fed(FedAvgSync(secure_agg=SecureAgg(seed=3))))
    _assert_tree_close(got["params"], want["params"])
    step = torch.tensor(8, dtype=torch.int32)
    np.testing.assert_array_equal(
        SecureAgg(seed=3).round_key(step).numpy().astype(np.uint32),
        jax.random.key_data(jprivacy.SecureAgg(seed=3).round_key(jnp.int32(8))))


def test_secure_sync_survives_checkpoint_roundtrip(tmp_path):
    """The mask key is (seed, step)-derived and step is checkpointed: a
    restored run continues bit-identically to the uninterrupted one."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    fed = _fed(FedAvgSync(secure_agg=SecureAgg(seed=3)))
    mid, _ = _run_rounds(fed, n_rounds=1)
    save_checkpoint(str(tmp_path), mid, step=4)
    loaded, _ = restore_checkpoint(str(tmp_path), device="cpu")
    state = tree_map(lambda l, m: l.reshape(m.shape).to(m.dtype), loaded, mid)
    assert int(state["step"]) == int(mid["step"])
    cont_mem, _ = _run_rounds(fed, n_rounds=2)
    cont_ckpt, _ = fed.round(state, {"x": torch.from_numpy(_xs((1, 4), 1))})
    assert _leaves_equal(cont_mem["params"], cont_ckpt["params"])


def test_secure_refusal_matrix():
    from repro.comm import IntQuant as JQuant
    from repro_torch.comm import IntQuant
    cfg = FedGANConfig(agent_grid=(1, 4), sync_interval=4)
    with pytest.raises(ValueError, match="codec"):
        FedAvgSync(secure_agg=SecureAgg(), codec=IntQuant(bits=8)).validate(cfg)
    with pytest.raises(ValueError, match="32-bit wire image"):
        FedAvgSync(secure_agg=SecureAgg(), sync_dtype=torch.bfloat16).validate(cfg)
    with pytest.raises(ValueError, match="dropouts"):
        SubsampledFedAvg(secure_agg=SecureAgg()).validate(cfg)
    for robust in (TrimmedMeanSync, CoordinateMedianSync):
        with pytest.raises(ValueError, match="secure sum hides"):
            robust(secure_agg=SecureAgg()).validate(cfg)
    with pytest.raises(ValueError, match="32-bit wire image"):
        collectives.masked_sync({"h": torch.ones((1, 2, 3), dtype=torch.bfloat16)},
                                torch.full((1, 2), 0.5), _tkey(0, 0))
    tree = {"h": torch.ones((1, 2, 3))}
    w = torch.full((1, 2), 0.5)
    with pytest.raises(ValueError, match="secure sum hides"):
        collectives.masked_sync(tree, w, _tkey(0, 0),
                                reduce=collectives.make_robust_reduce("median"))
    with pytest.raises(ValueError, match="pad cancellation"):
        collectives.masked_sync(tree, w, _tkey(0, 0), sync_dtype=torch.float32)
    # the reference's refusal messages, one by one
    jcfg = JConfig(agent_grid=(1, 4), sync_interval=4)
    for tcase, jcase in (
            (FedAvgSync(secure_agg=SecureAgg(), codec=IntQuant(bits=8)),
             jstrat.FedAvgSync(secure_agg=jprivacy.SecureAgg(), codec=JQuant(bits=8))),
            (SubsampledFedAvg(secure_agg=SecureAgg()),
             jstrat.SubsampledFedAvg(secure_agg=jprivacy.SecureAgg())),
            (TrimmedMeanSync(secure_agg=SecureAgg()),
             jstrat.TrimmedMeanSync(secure_agg=jprivacy.SecureAgg()))):
        with pytest.raises(ValueError) as te:
            tcase.validate(cfg)
        with pytest.raises(ValueError) as je:
            jcase.validate(jcfg)
        assert str(te.value).replace("repro_torch", "repro") == str(je.value)


def test_masked_sync_weights_ride_the_payload():
    """Weight-then-mask: the wire is the masked bits of w_i·x_i, not of
    x_i; unmasked it is w_i·x_i exactly."""
    x = torch.full((1, 2, 4), 2.0)
    w = torch.tensor([[0.75, 0.25]])
    key = _tkey(0, 3)
    m = collectives._pairwise_masks(prng.fold_in_t(key, 0), (1, 2), (4,))
    wire_weighted = collectives.masked_wire({"p": x}, w, key)["p"]
    assert torch.equal(wire_weighted, (collectives._to_bits(x * w[..., None]) + m) & 0xFFFFFFFF)
    wire_unweighted = (collectives._to_bits(x) + m) & 0xFFFFFFFF
    assert not torch.equal(wire_weighted, wire_unweighted)
    rec = collectives._from_bits((wire_weighted - m) & 0xFFFFFFFF)
    assert torch.equal(rec, x * w[..., None])
    out = collectives.masked_sync({"p": x}, w, key)
    assert torch.equal(out["p"], collectives.average_agents({"p": x}, w)["p"])


class _Largest(TorchDispatchMode):
    """Records the largest element count of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.biggest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.biggest = max(self.biggest, t.numel())
        return out


@pytest.mark.parametrize("B", [4, 8, 12])
def test_pairwise_masks_memory_is_linear_in_agents(B):
    """The twin of the reference's jaxpr-size test: every tensor the mask
    accumulator makes (recorded op by op) holds at most 4·B·leaf elements,
    never the B²·leaf of a materialised pair tensor."""
    leaf = 32
    key = prng.key_t(prng.key(0), "cpu")
    with _Largest() as mode:
        collectives._pairwise_masks(key, (1, B), (leaf,))
    assert B * leaf <= mode.biggest <= 4 * B * leaf, mode.biggest


# ---------------------------------------------------------------------------
# CLI + sweep integration
# ---------------------------------------------------------------------------


def test_cli_privacy_flags():
    from repro.launch.train import (build_parser as jparser, dp_from_args as jdp,
                                    strategy_from_args as jstrategy)
    from repro_torch.launch.train import build_parser, dp_from_args, strategy_from_args

    def args(*argv):
        return build_parser().parse_args(["--experiment", "toy_2d", *argv])

    a = args("--robust", "trimmed_mean", "--trim", "2", "--dp-noise", "0.5")
    strat, dp = strategy_from_args(a), dp_from_args(a)
    assert strat == TrimmedMeanSync(trim=2)
    assert dp == DPSGD(clip=1.0, noise_multiplier=0.5)
    assert dp_from_args(args()) is None
    assert dp_from_args(args("--dp-clip", "0.2")) == DPSGD(clip=0.2, noise_multiplier=0.0)
    assert dp_from_args(args("--dp-noise", "1", "--dp-delta", "1e-6")).delta == 1e-6
    assert strategy_from_args(args("--secure-agg", "--seed", "7")) == \
        FedAvgSync(secure_agg=SecureAgg(seed=7))
    for argv, match in ((("--robust", "median", "--strategy", "fedgan"), "conflicts"),
                        (("--strategy", "local_only", "--secure-agg"), "does not accept"),
                        (("--robust", "median", "--trim", "2"), "does not accept"),
                        (("--mode", "fedgan", "--secure-agg"), "requires --strategy")):
        with pytest.raises(ValueError, match=match):
            strategy_from_args(args(*argv))
        with pytest.raises(ValueError, match=match):
            jstrategy(jparser().parse_args(["--experiment", "toy_2d", *argv]))
    a, ja = args("--dp-noise", "0.5"), jparser().parse_args(["--experiment", "toy_2d",
                                                              "--dp-noise", "0.5"])
    assert dataclasses.asdict(dp_from_args(a)) == dataclasses.asdict(jdp(ja))


def test_privacy_sweep_end_to_end(tmp_path):
    """A tiny K x privacy grid through the device-resident runtime: the
    JSONL rows carry the privacy label (and dp_epsilon on the dp cell)."""
    from repro_torch.run.experiments import PRIVACY_AXES, _strategy_for, run_sweep
    cells = run_sweep("mixed_gaussian", [2, 4], privacy_names=["none", "dp", "trimmed_mean"],
                      steps=8, eval_n=128, out_dir=str(tmp_path), verbose=False, device="cpu")
    assert len(cells) == 6
    assert sorted({c.privacy for c in cells}) == ["dp", "none", "trimmed_mean"]
    rows = [json.loads(l) for l in open(os.path.join(tmp_path, "sweep_mixed_gaussian.jsonl"))]
    finals = [r for r in rows if r.get("final")]
    assert all("privacy" in r for r in rows)
    for r in finals:
        if r["privacy"] == "dp":
            assert r["dp_epsilon"] > 0
        else:
            assert "dp_epsilon" not in r
        assert r["bytes_per_round"] > 0
    with pytest.raises(ValueError, match="unknown privacy axis"):
        _strategy_for("fedgan", privacy="bogus")
    with pytest.raises(ValueError, match="codec wire"):
        _strategy_for("fedgan", codec="int8", privacy="secure")
    assert set(PRIVACY_AXES) == {"none", "dp", "secure", "trimmed_mean", "median"}


@pytest.mark.parametrize("privacy", ["none", "dp", "secure", "trimmed_mean", "median"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sweep_cells_match_the_reference(privacy, codec):
    """``_strategy_for`` builds the reference's (strategy, dp) pair: the
    same classes, fields and refusals."""
    from repro.run.experiments import _strategy_for as jfor
    from repro_torch.run.experiments import _strategy_for
    if privacy == "secure" and codec != "none":
        with pytest.raises(ValueError) as te:
            _strategy_for("fedgan", codec, privacy)
        with pytest.raises(ValueError) as je:
            jfor("fedgan", codec, privacy)
        assert str(te.value) == str(je.value)
        return
    (s, dp), (js, jdp) = _strategy_for("fedgan", codec, privacy), jfor("fedgan", codec, privacy)
    assert (s is None) == (js is None) and (dp is None) == (jdp is None)
    if s is not None:
        assert type(s).__name__ == type(js).__name__ and s.name == js.name
        assert (s.codec is None) == (js.codec is None)
        assert (s.secure_agg is None) == (js.secure_agg is None)
    if dp is not None:
        assert dataclasses.asdict(dp) == dataclasses.asdict(jdp)


def test_registry_and_exports_match_the_reference():
    import repro_torch.privacy as tp
    assert sorted(tp.__all__) == sorted(jprivacy.__all__)
    assert set(tstrat.STRATEGIES) == set(jstrat.STRATEGIES)
    assert tdpsgd.DPSGD.__dataclass_fields__.keys() == jprivacy.DPSGD.__dataclass_fields__.keys()
    for name in ("trimmed_mean", "median"):
        assert tstrat.get_strategy(name).name == jstrat.get_strategy(name).name
    assert WithByzantine(TrimmedMeanSync(), "nan", 2).name == \
        jprivacy.WithByzantine(jstrat.TrimmedMeanSync(), "nan", 2).name
