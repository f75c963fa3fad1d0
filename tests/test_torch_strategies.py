"""The port's sync strategies against the JAX reference, on the CPU.

Round for round: the same FedGAN in both packages (ACGAN nets at 8x8,
K = 2, or 1 for the per-step baseline, batch 8, SGD at 0.05,
``torch_shared._strategy_pair``), each round started from the reference's
state of the round before, held to ``torch_shared.assert_round_close``'s
bounds: within 1e-5 of each leaf's magnitude; with an int8 codec one
quantum of the leaf's coarsest block, and with a ``sync_dtype`` one ulp of
the wire type on the synced value, on at most 2% of the elements.  The port's round runs with oneDNN off, as
the other rounds held to the reference do.  Exact equality: the wire bytes each
strategy bills, the legacy-mode shim, the CLI's flags, ``dataset_weights``.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import (K, _batches, _strategy_pair, assert_round_close,  # noqa: F401
                          one_torch_thread)

from repro.comm import IntQuant as JQuant
from repro.core import fedgan as jfedgan, strategies as jstrat
from repro.core.participation import ParticipationSchedule as JSchedule
from repro.launch import train as jtrain

from repro_torch.comm import IntQuant
from repro_torch.convert import from_jax_params
from repro_torch.core import fedgan as tfedgan, strategies as tstrat
from repro_torch.core.participation import ParticipationSchedule
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves

BF16 = (jnp.bfloat16, torch.bfloat16)

# name: (grid, K, reference strategy, port strategy, rounds, agents synced
# after round r).  The per-step baseline runs at K = 1, as the paper runs
# it: each step then starts from the reference's state, and a leaky-ReLU
# input at rounding distance from its kink cannot flip within the round
# and carry its change to every agent through the average.
CASES = {
    "distributed": ((1, 5), 1, jstrat.PerStepGradAvg(), tstrat.PerStepGradAvg(), 3,
                    lambda r: True),
    "distributed_bf16": ((1, 5), 1, jstrat.PerStepGradAvg(sync_dtype=BF16[0]),
                         tstrat.PerStepGradAvg(sync_dtype=BF16[1]), 2, lambda r: True),
    "fedgan_bf16": ((1, 5), K, jstrat.FedAvgSync(sync_dtype=BF16[0]),
                    tstrat.FedAvgSync(sync_dtype=BF16[1]), 2, lambda r: True),
    "hierarchical": ((2, 2), K, jstrat.Hierarchical(intra_interval=1),
                     tstrat.Hierarchical(intra_interval=1), 2, lambda r: True),
    "adaptive_k": ((1, 5), K, jstrat.AdaptiveK(warmup_rounds=1, sync_every=2),
                   tstrat.AdaptiveK(warmup_rounds=1, sync_every=2), 3, lambda r: r != 1),
    "subsampled": ((1, 4), K, jstrat.SubsampledFedAvg(fraction=0.5),
                   tstrat.SubsampledFedAvg(fraction=0.5), 2, lambda r: False),
    "subsampled_int8": ((1, 4), K, jstrat.SubsampledFedAvg(fraction=0.5, codec=JQuant(8)),
                        tstrat.SubsampledFedAvg(fraction=0.5, codec=IntQuant(8)), 2,
                        lambda r: False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_strategy_round_matches_jax(case):
    grid, k, jstrategy, tstrategy, rounds, synced = CASES[case]
    jfed, tfed, lr = _strategy_pair("sgd", jstrategy, tstrategy, hw=8, grid=grid, k=k)
    codec = getattr(tstrategy, "codec", None) is not None
    rng = np.random.default_rng(1)
    jstate = jfed.init_state(jax.random.key(0))
    # the reference's sync_dtype average rounds each product to the wire
    # type op by op, not compiled (see torch_shared.assert_round_close): its
    # round sync runs op by op here, its K steps compiled in their scan
    jround = jfed.round if case == "fedgan_bf16" else jax.jit(jfed.round)
    seeds = jnp.zeros((k,) + grid, jnp.uint32)
    for r in range(rounds):
        batches = _batches(rng, grid, k)
        start = from_jax_params(jax.device_get(jstate), device="cpu")
        tbatches = from_jax_params(batches, device="cpu")
        # oneDNN's convolution backward under the agent vmap is not exact
        # float32, which the per-step average carries to every agent
        with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
            tstate, _ = tfed.round(start, tbatches)
            jstate, _ = jround(jstate, jax.tree_util.tree_map(jnp.asarray, batches), seeds)
            want = jax.device_get(jstate)
            assert_round_close(tfed, start, tbatches, tstate, want, "sgd", lr, codec,
                               synced=synced(r), wire=tstrategy.sync_dtype)
        if case.startswith("subsampled"):
            m = tstrategy.num_participants(tfed.cfg)
            cohort = ParticipationSchedule(0).cohort(r, 4, m)
            params = [x.reshape(4, -1) for x in tree_leaves(tstate["params"])]
            for a in range(4):
                same = all(torch.equal(x[a], x[cohort[0]]) for x in params)
                assert same == (a in cohort), (r, a, cohort)


def test_distributed_agents_stay_bit_identical():
    """Under PerStepGradAvg every agent takes the same averaged gradient
    at every step, so the agents never part."""
    _, tfed, _ = _strategy_pair("adam", None, tstrat.PerStepGradAvg(), hw=8)
    state = tfed.init_state(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        state, _ = tfed.round(state, from_jax_params(_batches(rng), device="cpu"))
        for key in ("params", "opt_g", "opt_d"):
            for x in tree_leaves(state[key]):
                assert torch.equal(x, x[:1, :1].expand_as(x))


def test_adaptive_k_skips_the_sync_on_off_rounds():
    strat = tstrat.AdaptiveK(warmup_rounds=1, sync_every=2)
    assert [strat.syncs_at(r) for r in range(6)] == [True, False, True, False, True, False]
    _, tfed, _ = _strategy_pair("sgd", None, strat, hw=8)
    state = tfed.init_state(torch.Generator().manual_seed(0), device="cpu")
    state = {**state, "step": torch.tensor(2 * K, dtype=torch.int32)}   # round 1 ends
    assert strat.round_sync(tfed, state) is state


def _acgan_states(grid=(1, 5)):
    jfed, tfed, _ = _strategy_pair("adam", None, None, hw=8, grid=grid)
    jstate = jfed.init_state(jax.random.key(0))
    return jfed, tfed, jstate, from_jax_params(jax.device_get(jstate), device="cpu")


BYTES_CASES = {
    "distributed": (jstrat.PerStepGradAvg(), tstrat.PerStepGradAvg()),
    "distributed_bf16": (jstrat.PerStepGradAvg(sync_dtype=BF16[0]),
                         tstrat.PerStepGradAvg(sync_dtype=BF16[1])),
    "fedgan_bf16_opt": (jstrat.FedAvgSync(sync_dtype=BF16[0], average_opt_state=True),
                        tstrat.FedAvgSync(sync_dtype=BF16[1], average_opt_state=True)),
    "hierarchical": (jstrat.Hierarchical(intra_interval=1, sync_dtype=BF16[0]),
                     tstrat.Hierarchical(intra_interval=1, sync_dtype=BF16[1])),
    "adaptive_k": (jstrat.AdaptiveK(sync_every=3), tstrat.AdaptiveK(sync_every=3)),
    "subsampled": (jstrat.SubsampledFedAvg(fraction=0.6),
                   tstrat.SubsampledFedAvg(fraction=0.6)),
    "subsampled_int8": (jstrat.SubsampledFedAvg(fraction=0.4, codec=JQuant(8)),
                        tstrat.SubsampledFedAvg(fraction=0.4, codec=IntQuant(8))),
}


@pytest.mark.parametrize("case", sorted(BYTES_CASES))
def test_bytes_per_round_match_jax(case):
    jfed, tfed, jstate, tstate = _acgan_states((2, 2) if case == "hierarchical" else (1, 5))
    js, ts = BYTES_CASES[case]
    jfed = dataclasses.replace(jfed, cfg=dataclasses.replace(jfed.cfg, strategy=js))
    tfed = dataclasses.replace(tfed, cfg=dataclasses.replace(tfed.cfg, strategy=ts))
    assert tfed.comm_bytes_per_round(tstate) == jfed.comm_bytes_per_round(jstate)


def _norm(v):
    """A value of either package in a comparable form: strategies and
    codecs as (class name, fields), dtypes by name.  The reference's
    codecs carry a ``use_kernel`` switch that the port has no need of (its
    wrappers dispatch on the device)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, _norm(getattr(v, f.name))) for f in dataclasses.fields(v)
            if f.name != "use_kernel")
    if isinstance(v, torch.dtype):
        return str(v).rsplit(".", 1)[-1]
    if isinstance(v, type) and hasattr(v, "dtype"):
        return jnp.dtype(v).name
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    return v


def test_strategy_from_mode_matches_the_reference():
    for mode in ("fedgan", "distributed", "local_only", "hierarchical"):
        for kw in ({}, {"sync_dtype": BF16}, {"intra_interval": 4, "average_opt_state": True}):
            if mode != "hierarchical" and "intra_interval" in kw:
                kw = {"average_opt_state": True}
            jkw = {k: (v[0] if k == "sync_dtype" else v) for k, v in kw.items()}
            tkw = {k: (v[1] if k == "sync_dtype" else v) for k, v in kw.items()}
            if mode == "local_only":
                jkw, tkw = {}, {}
            assert _norm(tstrat.strategy_from_mode(mode, **tkw)) == \
                _norm(jstrat.strategy_from_mode(mode, **jkw))
    with pytest.raises(ValueError, match="unknown mode"):
        tstrat.strategy_from_mode("bogus")


def test_legacy_config_fields_resolve_as_in_the_reference():
    for jkw, tkw in (({"mode": "distributed"}, {"mode": "distributed"}),
                     ({"mode": "hierarchical", "intra_interval": 2},
                      {"mode": "hierarchical", "intra_interval": 2}),
                     ({"sync_dtype": jnp.bfloat16}, {"sync_dtype": torch.bfloat16}),
                     ({"average_opt_state": True}, {"average_opt_state": True})):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jfedgan.FedGANConfig(**jkw).resolve_strategy()
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = tfedgan.FedGANConfig(**tkw).resolve_strategy()
        assert _norm(got) == _norm(want)
        kinds = lambda ws: [w.category for w in ws]  # noqa: E731
        assert kinds(tw) == kinds(jw)
        assert (DeprecationWarning in kinds(tw)) == ("mode" in tkw)
    for cfg in (jfedgan.FedGANConfig(strategy=jstrat.FedAvgSync(), sync_dtype=jnp.bfloat16),
                tfedgan.FedGANConfig(strategy=tstrat.FedAvgSync(), sync_dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="conflicts with the deprecated"):
            cfg.resolve_strategy()
    with pytest.raises(ValueError, match="unknown mode"):
        tfedgan.FedGANConfig(mode="bogus").validate()


def test_legacy_mode_round_is_the_explicit_strategy_round():
    _, tfed, _ = _strategy_pair("sgd", None, tstrat.PerStepGradAvg(sync_dtype=torch.bfloat16),
                                hw=8)
    legacy = dataclasses.replace(tfed, cfg=dataclasses.replace(
        tfed.cfg, strategy=None, mode="distributed", sync_dtype=torch.bfloat16))
    state = tfed.init_state(torch.Generator().manual_seed(0), device="cpu")
    batches = from_jax_params(_batches(np.random.default_rng(0)), device="cpu")
    want, _ = tfed.round(state, batches)
    with pytest.warns(DeprecationWarning):
        got, _ = legacy.round(state, batches)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_strategy_validation_matches_the_reference():
    jcfg, tcfg = jfedgan.FedGANConfig(sync_interval=4), tfedgan.FedGANConfig(sync_interval=4)
    cases = [
        (jstrat.FedAvgSync(sync_dtype=jnp.bfloat16, codec=JQuant(8)),
         tstrat.FedAvgSync(sync_dtype=torch.bfloat16, codec=IntQuant(8)), "both wire"),
        (jstrat.Hierarchical(intra_interval=3), tstrat.Hierarchical(intra_interval=3),
         "intra_interval"),
        (jstrat.Hierarchical(), tstrat.Hierarchical(), "intra_interval"),
        (jstrat.SubsampledFedAvg(fraction=0.0), tstrat.SubsampledFedAvg(fraction=0.0),
         "fraction"),
        (jstrat.AdaptiveK(sync_every=0), tstrat.AdaptiveK(sync_every=0), "sync_every"),
        (jstrat.SubsampledFedAvg(schedule=JSchedule(weights=(1.0,))),
         tstrat.SubsampledFedAvg(schedule=ParticipationSchedule(weights=(1.0,))), "weights"),
    ]
    for js, ts, match in cases:
        for s, cfg in ((js, jcfg), (ts, tcfg)):
            with pytest.raises(ValueError, match=match):
                s.validate(cfg)
    tstrat.Hierarchical(intra_interval=2).validate(tcfg)


def test_mask_seed_deprecation_warns_once():
    tstrat._MASK_SEED_WARNED = False
    with pytest.warns(DeprecationWarning, match="mask_seed"):
        s = tstrat.SubsampledFedAvg(mask_seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tstrat.SubsampledFedAvg(mask_seed=4)
    assert s.resolve_schedule() == ParticipationSchedule(seed=3)
    with pytest.raises(ValueError, match="drop mask_seed"):
        tstrat.SubsampledFedAvg(mask_seed=3, schedule=ParticipationSchedule()).validate(
            tfedgan.FedGANConfig())


def test_registry_holds_every_ported_strategy():
    assert set(tstrat.STRATEGIES) == set(jstrat.STRATEGIES)
    for name, cls in tstrat.STRATEGIES.items():
        assert cls.__name__ == jstrat.STRATEGIES[name].__name__
        assert cls().name == jstrat.STRATEGIES[name]().name
    for cls in (tstrat.SubsampledFedAvg, tstrat.AdaptiveK, tstrat.Hierarchical,
                tstrat.FedAvgSync, tstrat.TrimmedMeanSync, tstrat.CoordinateMedianSync):
        jcls = getattr(jstrat, cls.__name__)
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(jcls)]


def test_dataset_weights_and_run_spec_weights():
    sizes = np.array([[120, 300, 77, 1000, 3]], np.int64)
    got = tfedgan.dataset_weights(sizes)
    want = np.asarray(jfedgan.dataset_weights(sizes))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    spec, _ = ttrain.experiment_spec("toy_2d", device="cpu", steps=2, K=1, log_every=0)
    spec = dataclasses.replace(spec, weights=got)
    fed = spec.build()
    assert fed.weights is got
    torch.testing.assert_close(fed._w("cpu"), got / got.sum(), rtol=0, atol=0)
    result = spec.run_result()
    assert result.fed.weights is got


# argv (after --experiment image_acgan) -> the port's strategy where it
# departs from the reference (None: the same as the reference's)
_ARGV = [
    ([], None),
    (["--strategy", "distributed"], None),
    (["--strategy", "distributed", "--sync-dtype", "bf16"], None),
    (["--strategy", "fedgan", "--sync-dtype", "f16", "--average-opt-state"], None),
    (["--strategy", "hierarchical", "--intra-interval", "5"], None),
    (["--strategy", "subsampled", "--participation", "0.25", "--codec", "int8"], None),
    (["--strategy", "adaptive_k", "--warmup-rounds", "2", "--sync-every", "3"], None),
    (["--strategy", "partial_sharing", "--sync-dtype", "bfloat16"], None),
    (["--codec", "int4", "--topk", "0.25"], None),
    (["--mode", "distributed", "--sync-dtype", "bf16"], None),
    (["--mode", "hierarchical", "--intra-interval", "4", "--average-opt-state"], None),
    (["--mode", "fedgan", "--participation", "0.5"], None),
    # a strategy knob without --strategy or --mode: the reference drops it
    (["--average-opt-state"], tstrat.FedAvgSync(average_opt_state=True)),
    (["--sync-dtype", "bf16"], tstrat.FedAvgSync(sync_dtype=torch.bfloat16)),
]
_ARGV_ERRORS = [
    (["--strategy", "distributed", "--codec", "int8"], "does not accept"),
    (["--strategy", "fedgan", "--intra-interval", "5"], "does not accept"),
    (["--strategy", "hierarchical", "--participation", "0.5"], "does not accept"),
    (["--codec", "int8", "--sync-dtype", "bf16"], "both wire compressions"),
    (["--mode", "fedgan", "--codec", "int8"], "--codec requires --strategy"),
]


def _both(argv):
    full = ["--experiment", "image_acgan", *argv]
    return (ttrain.strategy_from_args(ttrain.build_parser().parse_args(full)),
            lambda: jtrain.strategy_from_args(jtrain.build_parser().parse_args(full)))


@pytest.mark.parametrize("i", range(len(_ARGV)))
def test_cli_flags_build_the_reference_strategy(i):
    argv, port_only = _ARGV[i]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got, want = _both(argv)
        if port_only is None:
            assert _norm(got) == _norm(want())
        else:
            assert want() is None and _norm(got) == _norm(port_only)


@pytest.mark.parametrize("i", range(len(_ARGV_ERRORS)))
def test_cli_flags_refuse_as_the_reference_does(i):
    argv, match = _ARGV_ERRORS[i]
    full = ["--experiment", "image_acgan", *argv]
    for mod in (ttrain, jtrain):
        with pytest.raises(ValueError, match=match):
            mod.strategy_from_args(mod.build_parser().parse_args(full))
    bare = ["--experiment", "image_acgan", "--participation", "0.5"]
    with pytest.raises(ValueError, match="does not accept"):
        ttrain.strategy_from_args(ttrain.build_parser().parse_args(bare))


# the port strategy that stands in for the reference's in a planted fault
PLANTED = {
    "distributed_without_average": ("distributed", tstrat.LocalOnly()),
    # averages every step, but in float32: sync_dtype ignored
    "distributed_bf16_without_cast": ("distributed_bf16", tstrat.PerStepGradAvg()),
    # seed 2 draws agents (1, 3) in round 0, seed 0 agents (0, 2)
    "subsampled_other_cohort": (
        "subsampled", tstrat.SubsampledFedAvg(fraction=0.5,
                                              schedule=ParticipationSchedule(seed=2))),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_strategy_round_comparison_rejects_planted_faults(fault):
    """The bounds above fail a port that skips the per-step average,
    averages off the wire type or draws another cohort."""
    case, planted = PLANTED[fault]
    if case == "subsampled":
        assert list(planted.resolve_schedule().cohort(0, 4, 2)) != \
            list(ParticipationSchedule(0).cohort(0, 4, 2))
    grid, k, jstrategy, tstrategy, _, synced = CASES[case]
    jfed, tfed, lr = _strategy_pair("sgd", jstrategy, planted, hw=8, grid=grid, k=k)
    rng = np.random.default_rng(1)
    jstate = jfed.init_state(jax.random.key(0))
    batches = _batches(rng, grid, k)
    start = from_jax_params(jax.device_get(jstate), device="cpu")
    tbatches = from_jax_params(batches, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        tstate, _ = tfed.round(start, tbatches)
        jstate, _ = jax.jit(jfed.round)(jstate, jax.tree_util.tree_map(jnp.asarray, batches),
                                        jnp.zeros((k,) + grid, jnp.uint32))
        with pytest.raises(AssertionError):
            assert_round_close(tfed, start, tbatches, tstate, jax.device_get(jstate), "sgd",
                               lr, False, synced=False, wire=tstrategy.sync_dtype)


def test_sweep_compares_against_the_distributed_baseline(tmp_path):
    """``--compare distributed`` runs the per-step baseline beside FedGAN,
    billing 2·M·K bytes a round against FedGAN's 2·M."""
    from repro_torch.run import experiments as texperiments
    cells = texperiments.main(["--sweep", "K=2", "--steps", "4", "--compare", "distributed",
                               "--eval-n", "32", "--out-dir", str(tmp_path), "--device", "cpu"])
    by = {c.strategy: c for c in cells}
    assert sorted(by) == ["distributed", "fedgan"]
    assert by["distributed"].bytes_per_round == 2 * by["fedgan"].bytes_per_round
    assert all(np.isfinite(c.final["fd"]) for c in cells)


def test_federated_images_twin_runs_on_the_cpu():
    """``python -m repro_torch.federated_images`` at a short depth: FedGAN
    and the distributed baseline train, and the checkpoint restores the
    state bit for bit and its score within the reference example's 1e-6."""
    from repro_torch import federated_images
    out = federated_images.run(K=2, steps=4, device="cpu", verbose=False)
    assert out["restored_equal"] and abs(out["fd_restored"] - out["fd"]) < 1e-6
    assert np.isfinite(out["fd"]) and np.isfinite(out["fd_distributed"])


@pytest.mark.parametrize("argv", [
    ["--strategy", "distributed", "--codec", "int8"],
    ["--strategy", "fedgan", "--codec", "int4", "--topk", "0.25"],
    ["--strategy", "fedgan", "--composed"],
    ["--sync-dtype", "bf16"],
])
def test_profile_refuses_knobs_it_would_drop(argv):
    """The profiler's output names the sync it ran, so a knob that would
    not reach that sync is an error, as in the training CLI."""
    from repro_torch.run import profile
    with pytest.raises(ValueError, match="strategy"):
        profile.main(["--experiment", "toy_2d", "--rounds", "1", "--device", "cpu", *argv])


def test_profile_takes_a_strategy():
    """``run.profile --strategy distributed --sync-dtype bf16`` profiles
    the per-step baseline's rounds (device numbers only on the card)."""
    from repro_torch.run import profile
    out = profile.main(["--experiment", "toy_2d", "--strategy", "distributed",
                        "--sync-dtype", "bf16", "--rounds", "1", "--device", "cpu"])
    assert out["strategy"] == "distributed" and out["ms_per_round"] > 0
    assert out["device_ms_per_round"] is None
