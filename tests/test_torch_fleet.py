"""The port's virtual-client fleet (``repro_torch.run.virtual`` and
``repro_torch.data.FleetRounds``) on the CPU, each behaviour the twin of
its case in ``tests/test_virtual_clients.py``, plus the fleet against the
JAX reference.

Tolerances:
* none (bit for bit) wherever both sides are the port: the identity fleet
  against the dense ``RoundDriver`` stream run (params, optimizer state,
  EF residuals, metrics), resume against the uninterrupted run, block-mode
  late against a fault-free run, paging round trips;
* none for ``FleetRounds`` against the reference's (the same Threefry
  bits);
* the deferred merge's closed form within 1e-6 (the reference's own
  bound);
* against the reference: a sampled-cohort round of the 8x8 ACGAN nets
  under Adam within ``torch_shared.round_mismatches`` (SGD 1e-5 of a
  leaf's magnitude, Adam 4 ulps + 2e-4 K lr, the batch-norm rules), from
  the reference's state and store, on the reference's batches; a
  deferred-merge run of the quadratic task and of the 8x8 ACGAN nets
  under SGD within 1e-5 of each leaf's magnitude (the SGD round bound),
  three rounds end to end.  The merge sums in agent order through the
  fedavg kernel's plain version where the reference's compiled einsum
  sums in another order, so these are not bit for bit.
"""
import dataclasses
import re
import types

import jax
import numpy as np
import pytest
import torch
from torch_shared import one_torch_thread, round_mismatches  # noqa: F401

from repro_torch import prng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.comm import IntQuant
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import (AdaptiveK, FedAvgSync, FedGAN, FedGANConfig,
                              PartialSharing, SubsampledFedAvg, TrimmedMeanSync)
from repro_torch.core.participation import ParticipationSchedule
from repro_torch.data import (FederatedRounds, FleetRounds, StreamingFederatedData,
                              stream_key_schedule)
from repro_torch.launch import train as ttrain
from repro_torch.optim import SGD, Adam, constant, equal_timescale
from repro_torch.run import RoundDriver
from repro_torch.run.simclock import demo_data, demo_task
from repro_torch.run.virtual import (ClientStore, StragglerPolicy, VirtualClientDriver,
                                     _pad_bucket, init_generators, load_fleet_checkpoint,
                                     plan_swap, state_axes)
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# fixtures: a small quadratic GAN on non-iid per-client shards
# ---------------------------------------------------------------------------


def small_task():
    """The quadratic GAN with its init drawn from the generator (so a
    template drawn otherwise than the dense slot would show)."""
    base = demo_task(0)

    def init(gen):
        return {"gen": {"theta": 0.1 * torch.randn(3, generator=gen)},
                "disc": {"w": 0.1 * torch.randn(3, generator=gen)}}

    return dataclasses.replace(base, init=init)


def client_shards(n_clients, size=32, seed=0):
    """Shard i is offset by i, so a mixup of clients or slots shows."""
    return demo_data(seed, n_clients, size)


def make_fed(strategy=None, grid=(1, 4), K=3, opt=None, task=None):
    opt = opt or SGD()
    return FedGAN(task or small_task(),
                  FedGANConfig(agent_grid=grid, sync_interval=K, strategy=strategy),
                  opt_g=opt, opt_d=opt, scales=equal_timescale(constant(0.05)))


def dense_result(strategy, agent_data, grid=(1, 4), K=3, n_rounds=5, seed=7, opt=None,
                 weights=None):
    """The port's dense stream run from the fleet's derivation of ``seed``
    (``init_generators``): the same init and the same round keys."""
    fed = dataclasses.replace(make_fed(strategy, grid, K, opt), weights=weights)
    data = StreamingFederatedData(FederatedRounds(agent_data, grid, 8, K), device="cpu")
    data_rng, init_gen = init_generators(seed)
    return RoundDriver(fed, data, n_rounds, log_every=0, verbose=False).run(
        data_rng, state=fed.init_state(init_gen(), device="cpu"))


def virtual_driver(strategy, agent_data, grid=(1, 4), K=3, n_rounds=5, opt=None, **kw):
    fed = make_fed(strategy, grid, K, opt)
    fleet = FleetRounds(agent_data, grid, batch_size=8, sync_interval=K)
    return VirtualClientDriver(fed, fleet, n_rounds, log_every=0, device="cpu", **kw)


def virtual_result(strategy, agent_data, grid=(1, 4), K=3, n_rounds=5, seed=7, opt=None,
                   **kw):
    driver = virtual_driver(strategy, agent_data, grid, K, n_rounds, opt, **kw)
    return driver, driver.run(seed)


def _np(x):
    return x.detach().cpu().contiguous().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# FleetRounds against the reference and the dense assembler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cohort", [[0, 1, 2, 3], [7, 2, 9, 4]], ids=["identity", "sampled"])
def test_fleet_rounds_match_the_reference(cohort):
    """The port's ``FleetRounds`` assembles the reference's round for the
    same key and cohort bit for bit (real samples and seeds; no latent
    draw here), and the identity cohort is ``FederatedRounds``' round."""
    from repro.data.federated import FleetRounds as JFleet
    data = client_shards(10)
    jdata = [{"x": jax.numpy.asarray(d["x"].numpy())} for d in data]
    ours = FleetRounds(data, (1, 4), batch_size=8, sync_interval=3)
    theirs = JFleet(jdata, (1, 4), batch_size=8, sync_interval=3)
    for seed in (0, 5):
        k = prng.fold_in(prng.key(seed), 3)
        b, s = ours.round_batches(k, cohort)
        jb, js = theirs.round_batches(jax.random.wrap_key_data(jax.numpy.asarray(k)), cohort)
        assert b["x"].shape == (3, 1, 4, 8, 3)
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(jb["x"]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        if cohort == [0, 1, 2, 3]:
            db, ds = FederatedRounds(data[:4], (1, 4), 8, 3).round_batches(k)
            assert torch.equal(db["x"], b["x"]) and torch.equal(ds, s)
    assert list(ours.client_sizes()) == [32] * 10
    with pytest.raises(ValueError, match="cohort ids"):
        ours.round_batches(prng.key(0), [0, 1])


# ---------------------------------------------------------------------------
# simulation parity: A_total == A_active + identity schedule == dense path
# ---------------------------------------------------------------------------

_PARITY_GRID = [
    ("fedavg", lambda codec: FedAvgSync(codec=codec) if codec else None),
    ("partial_sharing", lambda codec: PartialSharing(codec=codec)),
    ("adaptive_k", lambda codec: AdaptiveK(warmup_rounds=2, sync_every=2, codec=codec)),
]
PARITY_STRATEGIES = [
    (name if codec is None else f"{name}_int8", make(codec))
    for name, make in _PARITY_GRID for codec in (None, IntQuant(8))
] + [("subsampled", SubsampledFedAvg(fraction=0.5, schedule=ParticipationSchedule(seed=3)))]


@pytest.mark.parametrize("name,strategy", PARITY_STRATEGIES,
                         ids=[p[0] for p in PARITY_STRATEGIES])
def test_parity_bit_identical(name, strategy):
    """Full-fleet fleet run == the port's dense stream run, bit for bit:
    every state entry (params, Adam moments, EF residuals) and every
    metric."""
    data = client_shards(4)
    dense = dense_result(strategy, data, opt=Adam())
    _, virt = virtual_result(strategy, data, opt=Adam())
    assert set(dense.state) == set(virt.state)
    assert_trees_equal(dense.state, virt.state)
    assert dense.history == virt.history


def test_parity_covers_ef_residuals():
    """The codec parity case exercises error feedback: the residual is not
    zero."""
    _, virt = virtual_result(FedAvgSync(codec=IntQuant(8)), client_shards(4))
    assert "ef" in virt.state and "ef_down" in virt.state
    assert any(float(x.abs().max()) > 0 for x in tree_leaves(virt.state["ef"]))


def test_template_equals_a_dense_slot():
    """The store's template is a fresh dense init's slot, bit for bit
    (optimizer state and EF residuals included)."""
    fed = make_fed(FedAvgSync(codec=IntQuant(8)), opt=Adam())
    _, init_gen = init_generators(7)
    state = fed.init_state(init_gen(), device="cpu")
    store = ClientStore.from_fed(fed, init_gen(), 4)
    axes = state_axes(fed, state)
    assert sorted(store.template) == sorted(k for k, a in axes.items() if a == "client")
    for j in range(4):
        assert_trees_equal(store.template,
                           {k: tree_map(lambda x: x[0, j], state[k]) for k in store.template})


def test_identity_schedule_swaps_nothing():
    driver, virt = virtual_result(None, client_shards(4), n_rounds=6)
    assert virt.timings["swapped_rows"] == 0
    assert virt.timings["a_total"] == virt.timings["a_active"] == 4
    assert virt.timings["data_kind"] == "virtual"
    assert driver.store.client_ids() == [0, 1, 2, 3]


def test_sampled_fleet_runs_and_pages():
    """12 clients on 4 slots: rows swap, the store holds only
    participants, the history stays finite."""
    driver, virt = virtual_result(None, client_shards(12), n_rounds=8, seed=9,
                                  schedule=ParticipationSchedule(seed=9))
    assert virt.timings["swapped_rows"] > 0
    assert 4 <= virt.timings["store_rows"] <= 12
    assert all(np.isfinite(m["d_loss"]) for m in virt.history)
    seen = set()
    for r in range(8):
        seen.update(int(c) for c in driver.cohort(r))
    assert set(driver.store.client_ids()) <= seen


def test_rounds_see_the_slot_grid_never_the_fleet():
    """Every round runs on (P, A_active): each state leaf and batch the
    round receives has the slot axes, and A_total (37, prime) is no
    dimension of any of them."""
    seen = []

    class Recording(FedGAN):
        def round(self, state, batches, gen=None):
            seen.extend(tuple(x.shape) for x in tree_leaves(state) + tree_leaves(batches))
            return super().round(state, batches, gen)

    fed = make_fed()
    fed = Recording(fed.task, fed.cfg, fed.opt_g, fed.opt_d, fed.scales)
    fleet = FleetRounds(client_shards(37, size=16), (1, 4), 8, 3)
    VirtualClientDriver(fed, fleet, 3, log_every=0, device="cpu",
                        schedule=ParticipationSchedule(seed=1)).run(0)
    assert seen and all(37 not in s for s in seen)
    assert all(s[:2] == (1, 4) or s[:3] == (3, 1, 4) or s == () for s in seen)


# ---------------------------------------------------------------------------
# fault injection: stragglers never corrupt the average
# ---------------------------------------------------------------------------


def faults_at(round_idx, spec):
    """A faults hook planting ``spec`` (client -> kind) at one round."""
    return lambda r, cohort: spec if r == round_idx else {}


def test_drop_reverts_client_and_renormalizes():
    """A dropped client's row equals its pre-round value (the round-0
    broadcast average), and the survivors move on."""
    data = client_shards(4)
    driver, virt = virtual_result(None, data, n_rounds=2, faults=faults_at(1, {2: "drop"}))
    assert virt.timings["dropped"] == 1
    _, one = virtual_result(None, data, n_rounds=1, faults=faults_at(9, {}))
    want = tree_map(lambda x: x[0, 0], one.state["params"])
    assert_trees_equal(driver.store.row(2)["params"], want)
    assert not np.allclose(driver.store.row(0)["params"]["gen"]["theta"],
                           _np(want["gen"]["theta"]))


def test_block_mode_treats_late_as_on_time():
    data = client_shards(4)
    _, clean = virtual_result(None, data, n_rounds=3, faults=faults_at(9, {}))
    _, late = virtual_result(None, data, n_rounds=3, faults=faults_at(1, {1: "late"}))
    assert_trees_equal(clean.state["params"], late.state["params"])
    assert late.timings["late"] == 0 and late.timings["merged_deltas"] == 0


def _delta_of_client(data, grid, K, seed, client):
    """What ``client`` trains in round 0 minus its init, from public pieces
    (the LocalOnly twin and the driver's key derivation)."""
    from repro_torch.core import LocalOnly
    fed = make_fed(None, grid, K)
    fed_local = dataclasses.replace(fed, cfg=dataclasses.replace(fed.cfg, strategy=LocalOnly()))
    fleet = FleetRounds(data, grid, batch_size=8, sync_interval=K)
    data_rng, init_gen = init_generators(seed)
    state = fed_local.init_state(init_gen(), device="cpu")
    b, _ = fleet.round_batches(stream_key_schedule(data_rng, 1)[0], list(range(len(data))))
    post, _ = fed_local.round(state, b)
    P, A = grid
    return tree_map(lambda x, y: _np(x)[client // A, client % A] - _np(y)[client // A, client % A],
                    post["params"], state["params"])


@pytest.mark.parametrize("delay,gamma", [(1, 0.5), (2, 0.25)])
def test_late_delta_merges_with_staleness_decay(delay, gamma):
    """A delta submitted at round 0 arriving ``delay`` rounds later folds
    in as ``gamma**delay * w_share * delta``: a decay-``gamma`` run minus a
    decay-0 run is that term on every on-time slot, within 1e-6."""
    data = client_shards(4)
    kw = dict(n_rounds=1 + delay, faults=faults_at(0, {1: f"late:{delay}"}))
    _, base = virtual_result(None, data, straggler=StragglerPolicy(
        mode="defer", decay=0.0, max_staleness=2), **kw)
    _, dec = virtual_result(None, data, straggler=StragglerPolicy(
        mode="defer", decay=gamma, max_staleness=2), **kw)
    assert dec.timings["late"] == 1 and dec.timings["merged_deltas"] == 1
    delta = _delta_of_client(data, (1, 4), 3, 7, 1)
    scale = (gamma ** delay) * (1.0 / 4.0)
    for key, leaf in (("gen", "theta"), ("disc", "w")):
        got = _np(dec.state["params"][key][leaf]) - _np(base.state["params"][key][leaf])
        want = scale * delta[key][leaf]
        np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=0, atol=1e-6)


def test_expired_delta_is_discarded():
    data = client_shards(4)
    kw = dict(n_rounds=5, straggler=StragglerPolicy(mode="defer", decay=0.9, max_staleness=2))
    _, expired = virtual_result(None, data, faults=faults_at(0, {2: "late:4"}), **kw)
    _, never = virtual_result(None, data, faults=faults_at(0, {2: "late:99"}), **kw)
    assert expired.timings["expired_deltas"] == 1
    assert expired.timings["merged_deltas"] == 0
    assert_trees_equal(expired.state, never.state)


# ---------------------------------------------------------------------------
# refusals, with the reference's messages
# ---------------------------------------------------------------------------


def _run(**kw):
    n = kw.pop("n_clients", 4)
    grid = kw.pop("grid", (1, 4))
    return lambda: virtual_driver(None, client_shards(n), grid=grid, n_rounds=2, **kw).run(0)


def _weights_refusal():
    driver = virtual_driver(None, client_shards(4))
    driver.fed = dataclasses.replace(driver.fed, weights=torch.ones(1, 4) / 4)
    driver.__post_init__()


def _resume_without_store():
    state = make_fed().init_state(torch.Generator().manual_seed(0), device="cpu")
    virtual_driver(None, client_shards(4), n_rounds=2).run(0, state=state, start_round=1)


def _dense_checkpoint(tmp):
    save_checkpoint(tmp, {"params": np.zeros(3)}, step=1)
    load_fleet_checkpoint(tmp, device="cpu")


REFUSALS = [
    ("all_faulted", _run(grid=(1, 2), n_clients=2,
                         faults=faults_at(0, {0: "drop", 1: "drop"})),
     "every cohort member faulted"),
    ("absent_client", _run(faults=faults_at(0, {9: "drop"})), "not in this round's cohort"),
    ("unknown_fault", _run(faults=faults_at(0, {0: "tardy"})), "unknown fault"),
    ("faults_with_checkpoints", lambda: virtual_driver(
        None, client_shards(4), faults=faults_at(0, {}), ckpt_every=2, ckpt_dir="x"),
     "fault-injection"),
    ("secure_agg_sampled", lambda: virtual_driver(
        FedAvgSync(secure_agg=__import__("repro_torch.privacy", fromlist=["SecureAgg"])
                   .SecureAgg(seed=0)), client_shards(8)), "uncancelled"),
    ("weighting", lambda: virtual_driver(None, client_shards(4), weighting="fastest"),
     "weighting"),
    ("slot_grid", lambda: VirtualClientDriver(make_fed(None, (1, 2)),
                                              FleetRounds(client_shards(4), (1, 4), 8, 3), 2,
                                              device="cpu"), "slot_grid"),
    ("eval_hooks", lambda: virtual_driver(None, client_shards(4), eval_every=2),
     "eval_hooks is empty"),
    ("fed_weights", _weights_refusal, "FedGAN.weights"),
    ("start_round", lambda: virtual_driver(None, client_shards(4), n_rounds=3).run(
        0, start_round=3), "start_round"),
    ("cannot_fill", lambda: FleetRounds(client_shards(2), (1, 4), 8, 3), "cannot fill"),
    ("resume_without_store", _resume_without_store, "pass store="),
    ("undeclared_state", lambda: state_axes(make_fed(), {
        **make_fed().init_state(torch.Generator(), device="cpu"), "mystery": 0}),
     "without declaring"),
    ("out_of_fleet", lambda: ClientStore({"x": np.zeros(2)}, n_total=4).put(4, {}),
     "outside fleet"),
]


@pytest.mark.parametrize("name,fn,msg", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_refusals(name, fn, msg):
    with pytest.raises(ValueError, match=re.escape(msg)):
        fn()


def test_dense_checkpoint_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not a virtual-client"):
        _dense_checkpoint(str(tmp_path))


UNMERGEABLE = [FedAvgSync(codec=IntQuant(8)), FedAvgSync(sync_dtype=torch.bfloat16),
               FedAvgSync(average_opt_state=True), TrimmedMeanSync()]


@pytest.mark.parametrize("strategy", UNMERGEABLE,
                         ids=["codec", "sync_dtype", "average_opt_state", "trimmed_mean"])
@pytest.mark.parametrize("how", ["faults", "defer"])
def test_merge_path_refuses_unmergeable_strategies(strategy, how):
    """The split path's merge is plain weighted FedAvg; anything else is
    refused at construction with the reference's message."""
    kw = ({"faults": faults_at(0, {})} if how == "faults"
          else {"straggler": StragglerPolicy(mode="defer")})
    with pytest.raises(ValueError, match="straggler-tolerant merge") as e:
        virtual_driver(strategy, client_shards(4), n_rounds=2, **kw)
    assert strategy.name in str(e.value)


def test_secure_agg_runs_on_the_whole_fleet():
    from repro_torch.privacy import SecureAgg
    strat = FedAvgSync(secure_agg=SecureAgg(seed=0))
    dense = dense_result(strat, client_shards(4), n_rounds=2)
    _, virt = virtual_result(strat, client_shards(4), n_rounds=2)
    assert_trees_equal(dense.state, virt.state)


# ---------------------------------------------------------------------------
# paging soundness
# ---------------------------------------------------------------------------


def test_plan_swap_is_sticky_and_minimal():
    slots, evicted, entering = plan_swap([3, 7, 1], [1, 5, 7])
    assert evicted == [0] and entering == [5] and slots == [5, 7, 1]
    slots, evicted, entering = plan_swap([2, 4], [4, 2])
    assert evicted == [] and entering == [] and slots == [2, 4]
    assert _pad_bucket([]) == []
    assert _pad_bucket([4, 5, 6]) == [4, 5, 6, 4]
    assert [len(_pad_bucket(list(range(n)))) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]


def test_swap_roundtrip_bit_exact():
    """fetch -> store -> gather -> apply is the identity on slot state,
    a synced (stride-0) leaf included."""
    fed = make_fed(opt=Adam())
    driver = virtual_driver(None, client_shards(4), n_rounds=1, opt=Adam())
    driver._pager = __import__("repro_torch.run.virtual", fromlist=["_RowPager"]) \
        ._RowPager(torch.device("cpu"))
    state = fed.init_state(torch.Generator().manual_seed(5), device="cpu")
    state["params"]["gen"]["theta"] = state["params"]["gen"]["theta"][:1, :1].expand(1, 4, 3)
    driver.store = ClientStore.from_fed(fed, torch.Generator().manual_seed(5), 4)
    axes = state_axes(fed, state)
    rows = driver._fetch_slots(state, [0, 1, 2, 3], axes)
    driver.store.scatter([0, 1, 2, 3], rows)
    staged = tree_map(torch.from_numpy, driver.store.gather([3, 1]))
    state2 = driver._apply_swap(state, [3, 1], staged, axes)
    assert_trees_equal(state, state2)


def test_store_copy_on_write_and_template_immutable():
    driver, _ = virtual_result(None, client_shards(16), n_rounds=4, seed=3,
                               schedule=ParticipationSchedule(seed=3))
    template = driver.store.template
    before = tree_map(np.copy, template)
    untouched = set(range(16)) - set(driver.store.client_ids())
    assert untouched and driver.store.materialized < 16
    for c in untouched:
        assert driver.store.row(c) is template
    # a scattered row is private: writing into it reaches neither the
    # template nor another client's row
    cid = driver.store.client_ids()[0]
    other = driver.store.client_ids()[1]
    kept = tree_map(np.copy, driver.store.row(other))
    driver.store.row(cid)["params"]["gen"]["theta"][:] = 123.0
    assert_trees_equal(template, before)
    assert_trees_equal(driver.store.row(other), kept)


def test_ef_residuals_page_with_their_client():
    driver, virt = virtual_result(FedAvgSync(codec=IntQuant(8)), client_shards(8), n_rounds=6,
                                  seed=2, schedule=ParticipationSchedule(seed=2))
    assert virt.timings["swapped_rows"] > 0
    row = driver.store.row(driver.store.client_ids()[0])
    assert "ef" in row and "ef_down" not in row
    assert "params" in row and "opt_g" in row and "opt_d" in row


# ---------------------------------------------------------------------------
# checkpoint / resume: exact cohort replay
# ---------------------------------------------------------------------------


def test_resume_replays_run_bit_exactly(tmp_path):
    """Checkpoint mid-run, reload, resume: the final slot state and every
    host fleet row equal the uninterrupted run's, bit for bit."""
    data = client_shards(10)
    kw = dict(n_rounds=6, schedule=ParticipationSchedule(seed=5), opt=Adam())
    full_driver, full = virtual_result(None, data, seed=11, **kw)
    d = str(tmp_path)
    virtual_driver(None, data, ckpt_every=3, ckpt_dir=d, **kw).run(11)
    state, store, slot_clients, next_round, meta = load_fleet_checkpoint(d, step=9,
                                                                         device="cpu")
    assert next_round == 3 and meta["participation_seed"] == 5
    for leaf in tree_leaves(store.template) + [x for c in store.client_ids()
                                               for x in tree_leaves(store.row(c))]:
        assert isinstance(leaf, np.ndarray)
    resumed = virtual_driver(None, data, **kw)
    out = resumed.run(11, state=state, store=store, slot_clients=slot_clients,
                      start_round=3)
    assert_trees_equal(full.state, out.state)
    assert full.history[3:] == out.history
    assert full_driver.store.client_ids() == resumed.store.client_ids()
    for c in resumed.store.client_ids():
        assert_trees_equal(full_driver.store.row(c), resumed.store.row(c))


def test_dataset_weighting_matches_dense_weighted_run():
    """weighting='dataset' on the identity cohort == the dense run with
    the §3.1 |R_i| / sum |R_j| weights (``dataset_weights``), bit for
    bit."""
    from repro_torch.core import dataset_weights
    sizes = [17, 29, 53, 31]
    data = [client_shards(4, size=n)[i] for i, n in enumerate(sizes)]
    shares = dataset_weights(torch.tensor(sizes).reshape(1, 4))
    dense = dense_result(None, data, weights=shares)
    driver, virt = virtual_result(None, data, weighting="dataset")
    np.testing.assert_array_equal(driver._weights_row([0, 1, 2, 3]), shares.numpy().reshape(-1))
    assert_trees_equal(dense.state["params"], virt.state["params"])


def test_dp_rounds_draw_the_dense_noise():
    """Under DP-SGD the identity fleet refuses an understated sample rate,
    as the dense driver does, and draws the dense run's noise: bit for
    bit."""
    from repro_torch.privacy import DPSGD
    dp = DPSGD(clip=1.0, noise_multiplier=0.5, sample_rate=8 / 32)
    fed = dataclasses.replace(make_fed(), cfg=dataclasses.replace(make_fed().cfg, dp=dp))
    data = client_shards(4)
    stream = StreamingFederatedData(FederatedRounds(data, (1, 4), 8, 3), device="cpu")
    data_rng, init_gen = init_generators(7)
    dense = RoundDriver(fed, stream, 3, log_every=0, verbose=False).run(
        data_rng, state=fed.init_state(init_gen(), device="cpu"))
    virt = VirtualClientDriver(fed, FleetRounds(data, (1, 4), 8, 3), 3, log_every=0,
                               device="cpu").run(7)
    assert_trees_equal(dense.state, virt.state)
    assert virt.timings["dp_epsilon"] == dense.timings["dp_epsilon"]
    low = dataclasses.replace(fed, cfg=dataclasses.replace(fed.cfg, dp=dataclasses.replace(
        dp, sample_rate=0.01)))
    with pytest.raises(ValueError, match="understates"):
        VirtualClientDriver(low, FleetRounds(data, (1, 4), 8, 3), 3, device="cpu").run(7)


# ---------------------------------------------------------------------------
# launcher integration
# ---------------------------------------------------------------------------


def test_experiment_spec_fleet_wiring():
    spec, _ = ttrain.experiment_spec("mixed_gaussian", a_total=16, a_active=4, steps=10, K=5,
                                     log_every=0, device="cpu")
    assert spec.virtual and spec.a_total == 16 and spec.agent_grid == (1, 4)
    assert len(spec.agent_data) == 16 and spec.data_mode == "stream"
    assert spec.agent_data[0]["x"].shape[0] == 512
    assert all(x.device.type == "cpu" for d in spec.agent_data for x in d.values())
    fed, fleet = spec.build_fleet()
    assert fleet.num_clients == 16 and fleet.cohort_size == 4
    assert fed.cfg.agent_grid == (1, 4)


@pytest.mark.parametrize("kw,msg", [
    (dict(a_total=16, agents=4), "conflicts with"),
    (dict(a_total=4, a_active=8), "must be in"),
    (dict(a_total=8, rounds_per_chunk=4), "rounds_per_chunk=4 with a_total"),
    (dict(a_total=8, data_mode="device"), "data_mode='device' with a_total"),
    (dict(a_active=4), "they need a_total"),
    (dict(straggler_policy="defer"), "they need a_total"),
], ids=["agents", "a_active", "chunks", "device_data", "cohort_without_fleet",
        "policy_without_fleet"])
def test_experiment_spec_fleet_refusals(kw, msg):
    with pytest.raises(ValueError, match=re.escape(msg)):
        ttrain.experiment_spec("mixed_gaussian", device="cpu", samples_per_agent=16, **kw)


def test_cli_fleet_smoke(capsys):
    args = ttrain.build_parser().parse_args(
        ["--experiment", "mixed_gaussian", "--a-total", "8", "--a-active", "2",
         "--participation-seed", "3", "--straggler-policy", "defer"])
    assert (args.a_total, args.a_active) == (8, 2)
    assert args.participation_seed == 3 and args.straggler_policy == "defer"
    result = ttrain.main(["--experiment", "mixed_gaussian", "--a-total", "8",
                          "--a-active", "2", "--K", "2", "--steps", "4",
                          "--samples-per-agent", "32", "--batch-size", "8",
                          "--straggler-policy", "defer", "--device", "cpu"])
    assert len(result.history) == 2
    assert all(np.isfinite(h["d_loss"]) for h in result.history)
    assert result.timings["a_total"] == 8 and result.timings["a_active"] == 2
    assert "cohort=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# against the JAX reference
# ---------------------------------------------------------------------------


class _ReferenceFleet(FleetRounds):
    """A port fleet whose rounds are the reference fleet's for the same
    key and cohort (its latent draws included)."""

    def __init__(self, jfleet, agent_data):
        super().__init__(agent_data, jfleet.slot_grid, jfleet.batch_size, jfleet.sync_interval)
        self.jfleet = jfleet

    def round_batches(self, rng, slot_clients, out=None):
        jb, js = self.jfleet.round_batches(
            jax.random.wrap_key_data(jax.numpy.asarray(rng)), [int(c) for c in slot_clients])
        return (from_jax_params(jax.device_get(jb), device="cpu"),
                torch.from_numpy(np.asarray(js)))


def _acgan_fleet(n_clients, grid, K, opt, rng):
    """The 8x8 ACGAN FedGAN in both packages (``torch_shared``) and one
    fleet of ``n_clients`` shards of 16 images in both."""
    from repro.data.federated import FleetRounds as JFleet
    from torch_shared import _strategy_pair
    jfed, tfed, lr = _strategy_pair(opt, None, None, hw=8, grid=grid, k=K)
    shards = [{"x": rng.uniform(-1, 1, (16, 8, 8, 3)).astype(np.float32),
               "y": rng.integers(0, 10, (16,)).astype(np.int32)} for _ in range(n_clients)]
    extra = lambda r, s: {"z": jax.random.normal(r, s + (62,))}  # noqa: E731
    jfleet = JFleet([{k: jax.numpy.asarray(v) for k, v in d.items()} for d in shards], grid,
                    batch_size=8, sync_interval=K, sample_extra=extra)
    tfleet = _ReferenceFleet(jfleet, [tree_map(torch.from_numpy, d) for d in shards])
    return jfed, tfed, lr, jfleet, tfleet


def _jax_first_grads(jfed, params, batches):
    """Each agent's first-step (disc, gen) gradients in the reference."""
    from test_torch_driver import _jax_grads
    return _jax_grads(jfed, {"params": params}, batches)


def test_sampled_rounds_match_the_reference():
    """A sampled fleet (12 clients on 5 slots, Adam) in the reference; the
    port's fleet runs round 0 from the reference's init and round 1 from
    the reference's slot state, store and slots after round 0 (so its swap
    pages the reference's rows), each on the reference's batches, and each
    round is held within ``round_mismatches``.  K = 1 (``CARD_K``): at
    K = 2 a discriminator leaky-ReLU input at rounding distance from its
    kink flips on these batches and the second Adam step amplifies it, in
    the dense round too (``test_torch_paper.py``'s
    ``test_second_step_amplifies_a_flip_so_the_card_round_takes_one``)."""
    from repro.core.participation import ParticipationSchedule as JSchedule
    from repro.run.virtual import ClientStore as JStore, VirtualClientDriver as JDriver
    from torch_shared import CARD_K
    K, grid, seed, pseed = CARD_K, (1, 5), 3, 1
    jfed, tfed, lr, jfleet, tfleet = _acgan_fleet(12, grid, K, "adam",
                                                  np.random.default_rng(0))
    snaps = []

    def keep(fed, st, r):
        snaps.append((jax.device_get(st), {c: jax.tree_util.tree_map(
            np.copy, jdrv.store._rows[c]) for c in jdrv.store.client_ids()},
            list(jdrv.slot_clients)))
        return {}

    jdrv = JDriver(jfed, jfleet, 2, schedule=JSchedule(seed=pseed), log_every=0,
                   eval_every=1, eval_hooks=(keep,))
    jres = jdrv.run(jax.random.key(seed))
    _, init_rng = jax.random.split(jax.random.key(seed))
    init = jax.device_get(jfed.init_state(init_rng))
    template = jax.device_get(JStore.from_fed(jfed, init_rng, 12).template)
    exp = types.SimpleNamespace(opt="adam", lr_d=lr, lr_g=lr)
    keys = stream_key_schedule(init_generators(seed)[0], 2)
    cohorts = [list(ParticipationSchedule(seed=pseed).cohort(r, 12, 5)) for r in (0, 1)]
    assert cohorts[0] != cohorts[1]
    for r in (0, 1):
        if r == 0:
            start, rows, slots, start_slots = init, {}, None, cohorts[0]
        else:
            start, rows, slots = snaps[0]
            start_slots = plan_swap(slots, cohorts[1])[0]
        store = ClientStore(template, 12)
        for c, row in rows.items():
            store.put(c, row)
        # the reference's slot params at the round's start, after the swap
        params = jax.tree_util.tree_map(np.array, start["params"])
        for j, c in enumerate(start_slots):
            if slots is not None and slots[j] != c:
                for x, row in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(
                        rows.get(c, template)["params"])):
                    x[0, j] = row
        jb, _ = jfleet.round_batches(jax.random.wrap_key_data(jax.numpy.asarray(keys[r])),
                                     start_slots)
        grads = _jax_first_grads(jfed, params, jax.device_get(jb))
        drv = VirtualClientDriver(tfed, tfleet, r + 1, schedule=ParticipationSchedule(
            seed=pseed), log_every=0, device="cpu")
        with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
            out = drv.run(seed, state=from_jax_params(start, device="cpu"), store=store,
                          slot_clients=slots, start_round=r)
        want = snaps[r][0]
        assert drv.slot_clients == snaps[r][2]
        shift = lambda s: {**s, "step": np.asarray(s["step"]) - r * K}  # noqa: E731
        losses = ((out.history[0]["d_loss"], out.history[0]["g_loss"]),
                  (jres.history[r]["d_loss"], jres.history[r]["g_loss"]))
        bad, _ = round_mismatches(exp, K, shift(to_jax_params(out.state)), shift(want),
                                  grads, losses)
        assert bad == [], (r, bad[:5])
    assert jres.timings["swapped_rows"] > 0


def _deferred_pair(task_kind):
    """The reference's and the port's deferred-merge fleets (identity
    cohort of 4, decay 0.5; round 0 plants a drop and a ``late:1``, round 1
    another ``late:1``), the same init and batches: the quadratic task or the
    8x8 ACGAN nets under SGD."""
    from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig, GANTask as JTask
    from repro.data.federated import FleetRounds as JFleet
    from repro.optim import SGD as JSGD, constant as jconst, equal_timescale as jeq
    K, grid = 3, (1, 4)
    faults = lambda r, cohort: ({0: "drop", 2: "late:1"} if r == 0  # noqa: E731
                                else {1: "late:1"} if r == 1 else {})
    if task_kind == "quadratic":
        seed = 4
        ttask = demo_task(seed)
        init = jax.device_get(tree_map(lambda x: x.numpy(), ttask.init(None)))
        jnp = jax.numpy

        def disc_loss(p, b, rng):
            xm = jnp.mean(b["x"], axis=0)
            g = jax.lax.stop_gradient(p["gen"]["theta"])
            return -jnp.dot(p["disc"]["w"], xm - g) + 0.5 * jnp.sum(p["disc"]["w"] ** 2)

        def gen_loss(p, b, rng):
            return jnp.dot(jax.lax.stop_gradient(p["disc"]["w"]), p["gen"]["theta"])

        jtask = JTask(init=lambda rng: tree_map(jnp.asarray, init), disc_loss=disc_loss,
                      gen_loss=gen_loss)
        scales = (jeq(jconst(0.05)), equal_timescale(constant(0.05)))
        jfed = JFedGAN(jtask, JConfig(agent_grid=grid, sync_interval=K), opt_g=JSGD(),
                       opt_d=JSGD(), scales=scales[0])
        tfed = FedGAN(ttask, FedGANConfig(agent_grid=grid, sync_interval=K), opt_g=SGD(),
                      opt_d=SGD(), scales=scales[1])
        data = demo_data(seed, 4)
        jfleet = JFleet([{"x": jnp.asarray(d["x"].numpy())} for d in data], grid, 8, K)
        tfleet = FleetRounds(data, grid, 8, K)
    else:   # K = 1 (CARD_K): a second local step amplifies a leaky-ReLU flip
        from torch_shared import CARD_K
        jfed, tfed, _, jfleet, tfleet = _acgan_fleet(4, grid, CARD_K, "sgd",
                                                     np.random.default_rng(1))
    policy = dict(mode="defer", decay=0.5, max_staleness=2)
    return jfed, tfed, jfleet, tfleet, faults, policy


@pytest.mark.parametrize("task_kind", ["quadratic", "acgan"])
def test_deferred_merge_matches_the_reference(task_kind):
    """Three rounds of the deferred-merge path (drops reverted, late deltas
    merged decayed through the fedavg kernel's plain version) in both
    packages from the same init on the same batches: every leaf of the
    final params and optimizer state, and every host row, within 1e-5 of
    its magnitude (the SGD round bound); the same fault counts."""
    from repro.core.participation import ParticipationSchedule as JSchedule
    from repro.run.virtual import ClientStore as JStore, StragglerPolicy as JPolicy, \
        VirtualClientDriver as JDriver
    jfed, tfed, jfleet, tfleet, faults, policy = _deferred_pair(task_kind)
    seed = 2
    jdrv = JDriver(jfed, jfleet, 3, schedule=JSchedule(seed=0), straggler=JPolicy(**policy),
                   faults=faults, log_every=0)
    jres = jdrv.run(jax.random.key(seed))
    _, init_rng = jax.random.split(jax.random.key(seed))
    init = jax.device_get(jfed.init_state(init_rng))
    template = jax.device_get(JStore.from_fed(jfed, init_rng, 4).template)
    tdrv = VirtualClientDriver(tfed, tfleet, 3, straggler=StragglerPolicy(**policy),
                               faults=faults, log_every=0, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False, allow_tf32=None):
        tres = tdrv.run(seed, state=from_jax_params(init, device="cpu"),
                        store=ClientStore(template, 4))
    for k in ("late", "dropped", "merged_deltas", "expired_deltas"):
        assert tres.timings[k] == jres.timings[k], k
    assert tres.timings["merged_deltas"] == 2
    got = to_jax_params({k: tres.state[k] for k in ("params", "opt_g", "opt_d")})
    want = {k: jax.device_get(jres.state[k]) for k in ("params", "opt_g", "opt_d")}
    rows = [(tree_map(_np, tdrv.store.row(c)), jax.device_get(jdrv.store.row(c)))
            for c in range(4)]
    for g_tree, w_tree in [(got, want)] + rows:
        for g, w in zip(jax.tree_util.tree_leaves(g_tree), jax.tree_util.tree_leaves(w_tree)):
            g, w = np.asarray(g), np.asarray(w)
            lim = 1e-5 * max(1.0, float(np.abs(w).max()))
            assert np.abs(g.astype(np.float64) - w).max() <= lim


def test_params_digest_matches_the_reference_on_converted_params():
    """The port's digest of params converted from the reference equals
    the reference's digest of them."""
    from repro.run.simclock import params_digest as jdigest
    from repro_torch.run.simclock import params_digest
    from torch_shared import _strategy_pair
    jfed, _, _ = _strategy_pair("adam", None, None, hw=8)
    params = jax.device_get(jfed.init_state(jax.random.key(0))["params"])
    assert params_digest(from_jax_params(params, device="cpu")) == jdigest(params)
    assert params_digest(params) == jdigest(params)


def test_fleet_round_helper_holds_the_cpu_port():
    """The card check's deferred-straggler round (``torch_shared.
    port_fleet_round_mismatches``) run on the CPU against itself: within
    the bounds, the dropped slot reverted."""
    from torch_shared import port_fleet_round_mismatches
    (bad, _), dropped = port_fleet_round_mismatches("cpu")
    assert bad == [] and dropped


@pytest.mark.parametrize("wshape,lead", [((1,), (1,)), ((1, 1), (1, 1)), ((3,), (3,)),
                                         ((1, 3), (1, 3))], ids=["B1", "P1A1", "B3", "P1A3"])
def test_fedavg_tree_takes_the_weights_dims(wshape, lead):
    """``fedavg_tree`` reduces as many leading dims as make up the agents;
    a single agent (the async flush of one delta, a (1, 1) grid) takes the
    weights' own dims."""
    from repro_torch.kernels.fedavg.ops import fedavg_tree
    x = torch.arange(np.prod(lead) * 6, dtype=torch.float32).reshape(lead + (2, 3))
    w = torch.full(wshape, 1.0 / np.prod(wshape))
    out = fedavg_tree(w, {"x": x})["x"]
    assert out.shape == (2, 3)
    want = sum(x.reshape((-1, 2, 3))[b] * w.reshape(-1)[b] for b in range(w.numel()))
    assert torch.equal(out, want)
