"""The port's async buffered aggregation (``repro_torch.run.async_agg``) and
virtual-clock simulator (``repro_torch.run.simclock``) on the CPU, each
behaviour the twin of its case in ``tests/test_async_agg.py``, plus the
port against the JAX reference.

Tolerances:
* none (bit for bit, byte for byte) within the port: the degenerate
  (sync-equivalent) run against the dense ``RoundDriver`` and the per-round
  fleet, replays of a seeded run (journal and params), the CLI's journals;
* none against the reference for everything the schedule alone decides:
  latencies, ``modeled_sync_makespan``, staleness weights, the whole
  journal apart from its ``params_digest`` fields (the demo workload from
  the same numpy init and data), and ``params_digest`` of equal params;
* the demo run's final params against the reference's within 1e-6 of
  their magnitude: the flush sums the deltas in agent order through the
  fedavg kernel's plain version, the reference's compiled einsum in
  another order.
"""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_fleet import (assert_trees_equal, client_shards, dense_result, make_fed,
                              virtual_result)
from torch_shared import one_torch_thread  # noqa: F401

from repro_torch.comm import IntQuant
from repro_torch.core import (AdaptiveK, FedAvgSync, PartialSharing, SubsampledFedAvg,
                              TrimmedMeanSync, check_async_mergeable)
from repro_torch.core.participation import ParticipationSchedule
from repro_torch.data import FleetRounds
from repro_torch.optim import Adam
from repro_torch.privacy import SecureAgg
from repro_torch.run.async_agg import AsyncAggDriver, modeled_sync_makespan
from repro_torch.run.simclock import (EventJournal, LatencyModel, SimClock, demo_data,
                                      demo_driver, params_digest)
from repro_torch.run.virtual import StragglerPolicy, staleness_scale, staleness_weights
from repro_torch.tree import tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def async_driver(strategy, agent_data, grid=(1, 4), K=3, n_rounds=5, opt=None, **kw):
    fed = make_fed(strategy, grid, K, opt)
    fleet = FleetRounds(agent_data, grid, batch_size=8, sync_interval=K)
    return AsyncAggDriver(fed, fleet, n_rounds, log_every=0, device="cpu", **kw)


def in_flight_trace(journal):
    """The in-flight count after each event, from the journal."""
    n, trace = 0, []
    for r in journal.records:
        if r["ev"] == "dispatch":
            n += 1
        elif r["ev"] in ("arrival", "expired", "timeout"):
            n -= 1
        trace.append(n)
    return trace


# ---------------------------------------------------------------------------
# degenerate parity: async (goal = cohort, zero latency) == synchronous rounds
# ---------------------------------------------------------------------------

DEGENERATE_STRATEGIES = [
    ("fedavg", None),
    ("partial_sharing", PartialSharing()),
    ("codec_ef", FedAvgSync(codec=IntQuant(8))),
]


@pytest.mark.parametrize("name,strategy", DEGENERATE_STRATEGIES,
                         ids=[p[0] for p in DEGENERATE_STRATEGIES])
def test_degenerate_parity_bit_identical(name, strategy):
    """No latency, no timeout, a full-cohort goal: the dense run bit for
    bit, params, Adam moments, EF residuals and metrics."""
    data = client_shards(4)
    dense = dense_result(strategy, data, opt=Adam())
    res = async_driver(strategy, data, opt=Adam()).run(7)
    assert set(dense.state) == set(res.state)
    assert_trees_equal(dense.state, res.state)
    assert dense.history == res.history
    assert res.timings["mode"] == "sync_equivalent"


def test_degenerate_journal_shape_and_digest():
    drv = async_driver(None, client_shards(4), n_rounds=5)
    res = drv.run(7)
    counts = drv.journal.counts()
    assert counts["flush"] == 5
    assert counts["dispatch"] == counts["arrival"] == 5 * 4
    assert drv.journal.select("end")[-1]["params_digest"] == params_digest(res.state["params"])


def test_degenerate_matches_virtual_driver_exactly():
    data = client_shards(6)
    sched = ParticipationSchedule(seed=9)
    _, virt = virtual_result(None, data, n_rounds=4, schedule=sched)
    res = async_driver(None, data, n_rounds=4, schedule=sched).run(7)
    assert_trees_equal(virt.state, res.state)
    assert virt.history == res.history


# ---------------------------------------------------------------------------
# replay determinism: same seed -> byte-identical journal + params
# ---------------------------------------------------------------------------


def _demo_run(seed=7, **kw):
    drv = demo_driver(seed=seed, n_rounds=4, device="cpu", **kw)
    return drv, drv.run(seed)


def test_buffered_replay_bit_exact():
    d1, r1 = _demo_run()
    d2, r2 = _demo_run()
    assert d1.journal.canonical_bytes() == d2.journal.canonical_bytes()
    assert_trees_equal(r1.state["params"], r2.state["params"])
    assert r1.timings["makespan"] == r2.timings["makespan"]
    assert r1.timings["data_kind"] == "async" and r1.timings["store_rows"] <= 8


def test_buffered_other_seed_differs():
    assert _demo_run(seed=7)[0].journal.canonical_bytes() != \
        _demo_run(seed=8)[0].journal.canonical_bytes()


def test_journal_end_digest_matches_final_params():
    drv, res = _demo_run()
    assert drv.journal.select("end")[-1]["params_digest"] == params_digest(res.state["params"])


def test_cli_main_writes_identical_journals(tmp_path, capsys):
    from repro_torch.run import simclock
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    assert simclock.main(["--seed", "5", "--rounds", "3", "--out", a, "--device", "cpu"]) == 0
    assert simclock.main(["--seed", "5", "--rounds", "3", "--out", b, "--device", "cpu"]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    out = capsys.readouterr().out
    assert "params_digest=" in out and "makespan=" in out


def test_module_runs_give_byte_identical_journals(tmp_path):
    """``python -m repro_torch.run.simclock --device cpu`` twice, each in
    its own process: the journals are byte-identical, digest included."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    outs = []
    for name in ("a", "b"):
        path = str(tmp_path / f"{name}.jsonl")
        run = subprocess.run([sys.executable, "-m", "repro_torch.run.simclock", "--device",
                              "cpu", "--seed", "7", "--rounds", "6", "--out", path],
                             capture_output=True, text=True, env=env, timeout=300)
        assert run.returncode == 0, run.stderr
        assert "jax" not in run.stderr
        with open(path, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 20


# ---------------------------------------------------------------------------
# buffered semantics: goal, staleness weights, expiry, concurrency
# ---------------------------------------------------------------------------


def test_flush_fires_exactly_at_goal():
    drv, res = _demo_run(buffer_goal=2)
    flushes = drv.journal.select("flush")
    assert len(flushes) == 4 == res.timings["flushes"]
    assert all(f["merged"] == 2 for f in flushes)
    assert res.timings["merged_deltas"] == 8


def test_buffer_goal_one_merges_singletons():
    drv, _ = _demo_run(buffer_goal=1)
    assert all(f["merged"] == 1 and f["weights"] == [1.0] for f in drv.journal.select("flush"))


def test_in_flight_never_exceeds_cohort():
    drv, _ = _demo_run(cohort=4)
    assert max(in_flight_trace(drv.journal)) <= 4


def test_flush_weights_are_the_staleness_closed_form():
    """Every flush's weights are ``normalize(decay**staleness)`` bit for
    bit (decay 0.5 keeps the arithmetic in powers of two)."""
    drv, _ = _demo_run()
    saw_stale = False
    for f in drv.journal.select("flush"):
        np.testing.assert_array_equal(np.float32(f["weights"]),
                                      staleness_weights(f["staleness"], drv.straggler))
        assert all(0 <= s <= drv.straggler.max_staleness for s in f["staleness"])
        saw_stale |= any(s > 0 for s in f["staleness"])
    assert saw_stale, "the workload never produced a stale delta"


def test_expired_deltas_are_dropped_and_counted():
    drv = async_driver(None, client_shards(8), n_rounds=6, buffer_goal=1,
                       schedule=ParticipationSchedule(seed=7),
                       straggler=StragglerPolicy(mode="defer", decay=0.5, max_staleness=1),
                       latency=LatencyModel(base=1.0, jitter=0.5, straggler_frac=0.4,
                                            straggler_factor=16.0))
    res = drv.run(7)
    expired = drv.journal.select("expired")
    assert res.timings["expired_deltas"] == len(expired) > 0
    assert all(e["staleness"] > 1 for e in expired)
    assert all(s <= 1 for f in drv.journal.select("flush") for s in f["staleness"])


def test_constant_latency_makespan_closed_form():
    """Base-only latency and a full-cohort goal: lock step, flush k at
    exactly (k + 1) * base."""
    drv = async_driver(None, client_shards(4), n_rounds=3, latency=LatencyModel(base=2.0))
    res = drv.run(7)
    assert res.timings["mode"] == "buffered"
    assert res.timings["makespan"] == 3 * 2.0
    assert [f["t"] for f in drv.journal.select("flush")] == [2.0, 4.0, 6.0]
    assert all(np.isfinite(m["d_loss"]) for m in res.history)


def test_partial_sharing_buffered_leaves_disc_local():
    drv = async_driver(PartialSharing(), client_shards(4), n_rounds=3,
                       latency=LatencyModel(base=1.0))
    res = drv.run(7)
    assert set(res.state["params"]) == {"gen"}
    discs = [drv.store.row(c)["params"]["disc"]["w"] for c in drv.store.client_ids()]
    assert len(discs) >= 2 and any(not np.array_equal(discs[0], d) for d in discs[1:])


def test_dataset_weighting_scales_flush_weights():
    data = client_shards(4, size=16) + client_shards(4, size=48, seed=1)
    fed = make_fed(None, (1, 4), 3)
    drv = AsyncAggDriver(fed, FleetRounds(data, (1, 4), 8, 3), 3, log_every=0,
                         weighting="dataset", latency=LatencyModel(base=1.0), buffer_goal=2,
                         device="cpu")
    drv.run(7)
    for f in drv.journal.select("flush"):
        sizes = np.array([16.0 if c < 4 else 48.0 for c in f["clients"]])
        np.testing.assert_array_equal(np.float32(f["weights"]),
                                      staleness_weights(f["staleness"], drv.straggler, sizes))


# ---------------------------------------------------------------------------
# timeout / retry / backoff
# ---------------------------------------------------------------------------


def test_timeouts_retry_with_backed_off_budget():
    drv, _ = _demo_run()   # timeout 6, backoff 2, planted stragglers
    timeouts = drv.journal.select("timeout")
    assert timeouts
    dispatches = {r["seq"]: r for r in drv.journal.select("dispatch")}
    for ev in timeouts:
        d = dispatches[ev["seq"]]
        budget = drv.timeout * drv.backoff ** ev["attempt"]
        assert d["latency"] > budget
        assert ev["t"] - d["t"] == pytest.approx(budget, rel=1e-12)
    retries = drv.journal.select("retry")
    assert retries and all(r["attempt"] >= 1 for r in retries)


def test_retry_draws_fresh_latency():
    lm = LatencyModel(base=1.0, jitter=1.0)
    sched = ParticipationSchedule(seed=3)
    a = lm.draw(sched, dispatch_seq=5, client=2, n_total=8, attempt=0)
    assert a != lm.draw(sched, dispatch_seq=5, client=2, n_total=8, attempt=1)
    assert a == lm.draw(sched, 5, 2, 8, attempt=0)


def test_gave_up_is_loud_but_run_completes():
    drv = async_driver(None, client_shards(8), n_rounds=4, buffer_goal=2,
                       schedule=ParticipationSchedule(seed=5),
                       latency=LatencyModel(base=1.0, straggler_frac=0.5,
                                            straggler_factor=50.0),
                       timeout=2.0, max_retries=1, backoff=1.0)
    res = drv.run(5)
    assert res.timings["flushes"] == 4 and res.timings["gave_up"] > 0
    assert drv.journal.counts()["gave_up"] == res.timings["gave_up"]


def test_starvation_raises_loudly():
    drv = async_driver(None, client_shards(6), n_rounds=2, latency=LatencyModel(base=5.0),
                       timeout=1.0, max_retries=0)
    with pytest.raises(ValueError, match="starved"):
        drv.run(7)


def test_modeled_sync_makespan_is_the_blocking_cost():
    sched = ParticipationSchedule(seed=7)
    lm = LatencyModel(base=1.0, jitter=0.5, straggler_frac=0.25, straggler_factor=8.0)
    got = modeled_sync_makespan(sched, lm, n_rounds=3, n_total=8, m=4)
    expect = sum(max(lm.draw(sched, r, int(c), 8) for c in sched.cohort(r, 8, 4))
                 for r in range(3))
    assert got == expect > 3.0


# ---------------------------------------------------------------------------
# refusals, with the reference's messages
# ---------------------------------------------------------------------------


def _refused():
    """(name, the port's strategy, the reference's twin, a substring of the
    message); built at call time (the reference imports JAX)."""
    import jax.numpy as jnp

    from repro.comm import codec_from_flags
    from repro.core import strategies as js
    from repro.core.participation import ParticipationSchedule as JSchedule
    return [
        ("subsampled", SubsampledFedAvg(fraction=0.5, schedule=ParticipationSchedule(seed=3)),
         js.SubsampledFedAvg(fraction=0.5, schedule=JSchedule(seed=3)), "subsampled"),
        ("robust", TrimmedMeanSync(trim=1), js.TrimmedMeanSync(trim=1), "order statistic"),
        ("secure_agg", FedAvgSync(secure_agg=SecureAgg(seed=0)),
         js.FedAvgSync(secure_agg="pairwise"), "uncancelled"),
        ("codec", FedAvgSync(codec=IntQuant(8)),
         js.FedAvgSync(codec=codec_from_flags("int8")), "stale payloads"),
        ("sync_dtype", FedAvgSync(sync_dtype=torch.bfloat16),
         js.FedAvgSync(sync_dtype=jnp.bfloat16), "wire cast"),
        ("avg_opt", FedAvgSync(average_opt_state=True),
         js.FedAvgSync(average_opt_state=True), "moments stay local"),
        ("adaptive_k", AdaptiveK(), js.AdaptiveK(), "per-round driver"),
    ]


@pytest.mark.parametrize("i", range(7), ids=["subsampled", "robust", "secure_agg", "codec",
                                             "sync_dtype", "avg_opt", "adaptive_k"])
def test_check_async_mergeable_refuses(i):
    """Each refusal raises the reference's message, word for word."""
    from repro.core.strategies import check_async_mergeable as jcheck
    _, ours, theirs, msg = _refused()[i]
    with pytest.raises(ValueError, match=re.escape(msg)) as got:
        check_async_mergeable(ours)
    with pytest.raises(ValueError) as want:
        jcheck(theirs)
    assert str(got.value) == str(want.value)


def test_plain_strategies_are_async_mergeable():
    check_async_mergeable(FedAvgSync())
    check_async_mergeable(PartialSharing())


def test_buffered_construction_refuses_codec_but_degenerate_allows():
    strat = FedAvgSync(codec=IntQuant(8))
    async_driver(strat, client_shards(4))
    with pytest.raises(ValueError, match="codec"):
        async_driver(strat, client_shards(4), latency=LatencyModel(base=1.0))


@pytest.mark.parametrize("kw,msg", [
    (dict(buffer_goal=0), "buffer_goal"),
    (dict(buffer_goal=5), "buffer_goal"),
    (dict(timeout=0.0), "timeout"),
    (dict(latency=LatencyModel(base=1.0), backoff=0.5), "backoff"),
    (dict(latency=LatencyModel(base=1.0), max_retries=-1), "max_retries"),
    (dict(weighting="nope"), "weighting"),
    (dict(latency=LatencyModel(base=-1.0)), "base/jitter"),
], ids=["goal_zero", "goal_over_cohort", "timeout_zero", "backoff_lt_one",
        "neg_retries", "bad_weighting", "neg_latency"])
def test_constructor_validation(kw, msg):
    with pytest.raises(ValueError, match=msg):
        async_driver(None, client_shards(4), **kw)


# ---------------------------------------------------------------------------
# staleness-weight algebra: property-based invariants, and the reference's
# ---------------------------------------------------------------------------

_POLICY = StragglerPolicy(mode="defer", decay=0.5, max_staleness=3)


@settings(max_examples=25, deadline=None)
@given(stal=st.lists(st.integers(0, 6), min_size=1, max_size=8))
def test_weights_normalize_to_one_as_the_reference(stal):
    from repro.run.virtual import StragglerPolicy as JPolicy, staleness_weights as jweights
    w = staleness_weights(stal, _POLICY)
    if any(s <= _POLICY.max_staleness for s in stal):
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    else:
        assert w.sum() == 0.0
    np.testing.assert_array_equal(w, jweights(stal, JPolicy(mode="defer", decay=0.5,
                                                            max_staleness=3)))


@settings(max_examples=25, deadline=None)
@given(s=st.integers(0, 10), decay=st.floats(0.05, 1.0))
def test_scale_monotone_nonincreasing(s, decay):
    pol = StragglerPolicy(mode="defer", decay=decay, max_staleness=5)
    assert staleness_scale(s, pol) >= staleness_scale(s + 1, pol)


@settings(max_examples=25, deadline=None)
@given(s=st.integers(4, 20))
def test_past_max_staleness_is_exactly_zero(s):
    assert staleness_scale(s, _POLICY) == 0.0
    w = staleness_weights([0, 1, s], _POLICY)
    assert w[2] == 0.0 and w.sum() > 0


@settings(max_examples=20, deadline=None)
@given(perm=st.permutations(list(range(6))))
def test_weights_commute_with_permutation(perm):
    stal = [0, 1, 1, 2, 3, 0]
    base = staleness_weights(stal, _POLICY)
    np.testing.assert_array_equal(staleness_weights([stal[i] for i in perm], _POLICY),
                                  base[np.asarray(perm)])


def test_negative_staleness_refused():
    with pytest.raises(ValueError, match=">= 0"):
        staleness_scale(-1, _POLICY)


# ---------------------------------------------------------------------------
# simulator primitives
# ---------------------------------------------------------------------------


def test_simclock_orders_ties_by_push_sequence():
    clk = SimClock()
    clk.push(2.0, "b")
    clk.push(1.0, "a1", payload=1)
    clk.push(1.0, "a2", payload=2)
    assert clk.pop() == (1.0, "a1", 1)
    assert clk.pop() == (1.0, "a2", 2)
    assert clk.now == 1.0
    with pytest.raises(ValueError, match="before"):
        clk.push(0.5, "late")
    assert clk.pop()[1] == "b" and clk.now == 2.0


def test_journal_canonical_bytes_round_trip(tmp_path):
    j = EventJournal()
    j.append("flush", np.float64(1.5), merged=np.int64(3), w=[0.5, 0.5])
    j.append("end", 2.0)
    lines = j.canonical_bytes().decode().splitlines()
    assert lines[0] == '{"ev":"flush","i":0,"merged":3,"t":1.5,"w":[0.5,0.5]}'
    assert j.counts() == {"flush": 1, "end": 1}
    p = str(tmp_path / "j.jsonl")
    j.write(p)
    with open(p, "rb") as f:
        assert f.read() == j.canonical_bytes()


def test_arrival_uniforms_seeded_and_disjoint():
    sched = ParticipationSchedule(seed=11)
    u = sched.arrival_uniforms(3, 16)
    np.testing.assert_array_equal(u, sched.arrival_uniforms(3, 16))
    assert u.shape == (16,) and (u >= 0).all() and (u < 1).all()
    assert not np.array_equal(u, sched.arrival_uniforms(3, 16, salt=1))
    assert not np.array_equal(u, sched.arrival_uniforms(4, 16))


def test_params_digest_detects_any_leaf_change():
    tree = {"gen": {"theta": np.arange(3.0)}, "disc": {"w": np.ones(3)}}
    d0 = params_digest(tree)
    assert d0 == params_digest(tree_map(np.copy, tree))
    assert d0 == params_digest(tree_map(torch.from_numpy, tree))
    assert d0 != params_digest({"gen": {"theta": np.arange(3.0)},
                                "disc": {"w": np.ones(3) + 1e-9}})


# ---------------------------------------------------------------------------
# against the JAX reference
# ---------------------------------------------------------------------------


def test_latencies_and_modeled_makespan_are_the_reference():
    from repro.core.participation import ParticipationSchedule as JSchedule
    from repro.run.async_agg import modeled_sync_makespan as jmakespan
    from repro.run.simclock import LatencyModel as JLatency
    kw = dict(base=1.0, jitter=0.5, straggler_frac=0.25, straggler_factor=8.0)
    ours, theirs = (LatencyModel(**kw), ParticipationSchedule(seed=7)), \
        (JLatency(**kw), JSchedule(seed=7))
    for seq in range(20):
        for attempt in (0, 1):
            assert ours[0].draw(ours[1], seq, seq % 8, 8, attempt) == \
                theirs[0].draw(theirs[1], seq, seq % 8, 8, attempt)
    assert modeled_sync_makespan(ours[1], ours[0], 6, 64, 5) == \
        jmakespan(theirs[1], theirs[0], 6, 64, 5)


def _reference_demo(seed, n_rounds, **kw):
    """The reference's ``demo_driver`` workload on the port demo's numpy
    init and data (the reference's own demo draws them from
    ``jax.random``)."""
    import jax.numpy as jnp

    from repro.core import FedGAN, FedGANConfig, GANTask
    from repro.data.federated import FleetRounds as JFleet
    from repro.optim import SGD, constant, equal_timescale
    from repro.run.async_agg import AsyncAggDriver as JDriver
    from repro.run.simclock import LatencyModel as JLatency
    from repro.run.virtual import StragglerPolicy as JPolicy
    from repro.core.participation import ParticipationSchedule as JSchedule
    from repro_torch.run.simclock import demo_task
    init = tree_map(lambda x: x.numpy(), demo_task(seed).init(None))

    def disc_loss(p, b, rng):
        xm = jnp.mean(b["x"], axis=0)
        g = jax.lax.stop_gradient(p["gen"]["theta"])
        return -jnp.dot(p["disc"]["w"], xm - g) + 0.5 * jnp.sum(p["disc"]["w"] ** 2)

    def gen_loss(p, b, rng):
        return jnp.dot(jax.lax.stop_gradient(p["disc"]["w"]), p["gen"]["theta"])

    task = GANTask(init=lambda rng: tree_map(jnp.asarray, init), disc_loss=disc_loss,
                   gen_loss=gen_loss)
    n_clients, cohort = kw.get("n_clients", 8), kw.get("cohort", 4)
    grid = (1, cohort)
    fed = FedGAN(task, FedGANConfig(agent_grid=grid, sync_interval=3), opt_g=SGD(),
                 opt_d=SGD(), scales=equal_timescale(constant(0.05)))
    data = [{"x": jnp.asarray(d["x"].numpy())} for d in demo_data(seed, n_clients)]
    return JDriver(fed, JFleet(data, grid, batch_size=8, sync_interval=3), n_rounds,
                   schedule=JSchedule(seed=seed),
                   straggler=JPolicy(mode="defer", decay=0.5, max_staleness=2),
                   buffer_goal=kw.get("buffer_goal", 2),
                   latency=JLatency(base=1.0, jitter=0.5, straggler_frac=0.25,
                                    straggler_factor=8.0),
                   timeout=6.0, max_retries=2, backoff=2.0)


def _without_digests(journal):
    return [{k: v for k, v in r.items() if k != "params_digest"} for r in journal.records]


@pytest.mark.parametrize("seed,kw", [(7, {}), (3, {"n_clients": 16, "cohort": 5})],
                         ids=["demo", "sixteen_clients"])
def test_journal_and_params_match_the_reference(seed, kw):
    """The demo workload in both packages from the same numpy init and
    data: the journals are equal record for record apart from the
    ``params_digest`` fields (the canonical bytes of those records
    included), and the final params agree within 1e-6 of their
    magnitude."""
    jdrv = _reference_demo(seed, 6, **kw)
    jres = jdrv.run(jax.random.key(seed))
    tdrv = demo_driver(seed=seed, n_rounds=6, device="cpu", **kw)
    tres = tdrv.run(seed)
    assert _without_digests(tdrv.journal) == _without_digests(jdrv.journal)
    stripped = [r for r in tdrv.journal.records if "params_digest" not in r]
    assert len(stripped) > len(tdrv.journal.records) // 2
    for a, b in zip(tdrv.journal.canonical_bytes().splitlines(),
                    jdrv.journal.canonical_bytes().splitlines()):
        if b'"params_digest"' not in a:
            assert a == b
    for g, w in zip(jax.tree_util.tree_leaves(tres.state["params"]),
                    jax.tree_util.tree_leaves(jax.device_get(jres.state["params"]))):
        assert np.abs(g - np.asarray(w)).max() <= 1e-6 * max(1.0, float(np.abs(w).max()))
    assert tres.timings["makespan"] == jres.timings["makespan"]
    for k in ("flushes", "timeouts", "retries", "gave_up", "expired_deltas", "dispatches"):
        assert tres.timings[k] == jres.timings[k], k
