"""The port's round driver on the CPU, each case the twin of its case in
``tests/test_run_driver.py``: chunk sizes, chunked runs bit-invariant,
streamed runs bit-equal to the blocking loop, the stream slice against the
JAX reference, the hooks and checkpoints in chunks, and the refusals.

Tolerances: none, except the slice against JAX.  Chunking and streaming
change no arithmetic, so those runs are held bit for bit.  The port's
stream run against the reference's is held round by round, from the
reference's state after each round, to the bounds every round of the port
is held to (``torch_shared.round_mismatches``: SGD 1e-5 of each leaf's
magnitude, Adam 4 ulps plus 2e-4 K lr); the first-step losses there are
the round's mean losses, within the same 1e-5.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch_shared import one_torch_thread, round_mismatches  # noqa: F401

from repro.data import federated as jfed
from repro.launch import train as jtrain
from repro.run import driver as jdriver

from repro_torch import prng
from repro_torch.checkpoint import list_checkpoints
from repro_torch.configs import paper_gans as tpaper
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import PartialSharing
from repro_torch.data import (FederatedData, FederatedRounds, StreamingFederatedData,
                              stream_key_schedule)
from repro_torch.launch import train as ttrain
from repro_torch.run import RoundDriver
from repro_torch.run.driver import _chunk_sizes
from repro_torch.run.evals import eval_hook
from repro_torch.run.graph import metric_row
from repro_torch.tree import tree_leaves, tree_map


def _same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------


def test_chunk_sizes_respect_boundaries():
    """The reference's cases, verbatim, and the reference's own function
    on a grid of inputs."""
    assert _chunk_sizes(10, 4) == [4, 4, 2]
    assert _chunk_sizes(10, 4, 3) == [3, 3, 3, 1]  # never cross a %3 boundary
    assert _chunk_sizes(6, 100, 2, 3) == [2, 1, 1, 2]
    assert _chunk_sizes(5, 1) == [1] * 5
    for n, per, cads in ((17, 5, (4,)), (9, 3, (2, 5)), (8, 8, ())):
        sizes = _chunk_sizes(n, per, *cads)
        assert sum(sizes) == n and all(1 <= c <= per for c in sizes)
        r = 0
        for c in sizes:
            for cad in cads:
                assert c <= cad - r % cad, (n, per, cads, sizes, r, c)
            r += c
    for n in (0, 1, 7, 30):
        for per in (0, 1, 3, 8):
            for cads in ((), (0,), (4,), (3, 5), (0, 2)):
                assert _chunk_sizes(n, per, *cads) == jdriver._chunk_sizes(n, per, *cads)


@pytest.mark.parametrize("name", ["toy_2d", "mixed_gaussian"])
def test_driver_chunking_is_bit_invariant(name):
    """12 rounds at K = 5 in chunks of 1, 4 and 12: the same history and
    state bit for bit (the CPU runs every round eagerly; no graph)."""
    spec, _ = ttrain.experiment_spec(name, K=5, steps=60, log_every=0, device="cpu",
                                     samples_per_agent=256, batch_size=16)
    runs = {c: dataclasses.replace(spec, rounds_per_chunk=c).run_result() for c in (1, 4, 12)}
    for c in (4, 12):
        assert runs[c].history == runs[1].history
        assert _same_state(runs[c].state, runs[1].state)
        assert runs[c].timings["captured"] is False


def test_driver_eval_hooks_and_checkpoints_in_chunks(tmp_path):
    """Chunks of 3 never cross the eval and checkpoint cadence of 4: the
    hooks see rounds 3 and 7, the checkpoints land at steps 20 and 40."""
    spec, suite = ttrain.experiment_spec("toy_2d", K=5, steps=40, log_every=0, device="cpu",
                                         samples_per_agent=256)
    seen = []

    def hook(fed, state, r):
        seen.append((r, int(state["step"])))
        return eval_hook(suite, n=256)(fed, state, r)

    res = RoundDriver(spec.build(), spec.build_data(), 8, log_every=0, verbose=False,
                      eval_every=4, eval_hooks=(hook,), ckpt_every=4,
                      ckpt_dir=str(tmp_path), rounds_per_chunk=3).run(1)
    assert [e["round"] for e in res.evals] == [3, 7] and seen == [(3, 20), (7, 40)]
    assert all(np.isfinite(e["fd"]) for e in res.evals)
    assert list_checkpoints(str(tmp_path)) == [20, 40]
    assert res.timings["data_kind"] == "device" and len(res.history) == 8
    assert all(isinstance(v, float) for m in res.history for v in m.values())


def test_driver_refusals():
    spec, _ = ttrain.experiment_spec("toy_2d", K=5, steps=10, log_every=0, device="cpu")
    fed = spec.build()
    rounds = FederatedRounds([{k: v.cpu() for k, v in d.items()} for d in spec.agent_data],
                             spec.agent_grid, spec.batch_size, spec.K)
    with pytest.raises(ValueError, match="eval_hooks"):
        RoundDriver(fed, rounds, 2, eval_every=1)
    with pytest.raises(ValueError, match="rounds_per_chunk"):
        RoundDriver(fed, spec.build_data(), 2, rounds_per_chunk=0)
    with pytest.raises(ValueError, match="DeviceFederatedData"):
        RoundDriver(fed, spec.agent_data, 2)


def test_build_data_rejects_unknown_mode():
    spec, _ = ttrain.experiment_spec("toy_2d", K=5, steps=10, device="cpu")
    with pytest.raises(ValueError, match="data_mode"):
        dataclasses.replace(spec, data_mode="nonsense").build_data()


# ---------------------------------------------------------------------------
# the stream against the port's own blocking loop
# ---------------------------------------------------------------------------


def _blocking_loop(spec):
    """The blocking stream loop: rounds assembled one at a time from the
    reference's key schedule, ``FedGAN.round`` on each."""
    fed, data = spec.build(), spec.build_data()
    state = fed.init_state(torch.Generator().manual_seed(spec.seed), device="cpu")
    history = []
    for rb in stream_key_schedule(prng.key(spec.seed + 1), spec.n_rounds):
        batches, _ = data.rounds.round_batches(rb)
        state, m = fed.round(state, batches)
        history.append(dict(zip(sorted(m), metric_row(m, sorted(m)).tolist())))
    return state, history


@pytest.mark.parametrize("name,kw", [
    ("toy_2d", {"K": 20, "steps": 100, "samples_per_agent": 512}),
    ("timeseries_cgan", {"K": 4, "steps": 8, "batch_size": 16, "samples_per_agent": 128,
                         "strategy": PartialSharing()}),
], ids=["quickstart_settings", "partial_sharing_with_labels"])
def test_stream_run_matches_the_blocking_loop(name, kw):
    """``experiment_spec(data_mode="stream").run_result()`` gives the
    blocking loop's history and state bit for bit, at the quickstart's
    settings and under a non-default strategy with labels and latents
    (the twins of the reference's ``test_runspec_shim_parity_*``)."""
    spec, _ = ttrain.experiment_spec(name, seed=3, log_every=0, device="cpu",
                                     data_mode="stream", **kw)
    res = spec.run_result()
    state, history = _blocking_loop(spec)
    assert res.timings["data_kind"] == "stream" and res.timings["captured"] is False
    assert res.history == history
    assert _same_state(res.state, state)


def test_driver_wraps_a_bare_federated_rounds():
    """A bare ``FederatedRounds`` is wrapped into a prefetch-2 stream to
    the card, as the reference wraps it; the same stream to the CPU runs
    the rounds of the explicit pipeline."""
    spec, _ = ttrain.experiment_spec("toy_2d", K=5, steps=15, log_every=0, device="cpu",
                                     data_mode="stream", samples_per_agent=256)
    data = spec.build_data()
    fed = spec.build()
    wrapped = RoundDriver(fed, data.rounds, 3, log_every=0, verbose=False)
    assert isinstance(wrapped.data, StreamingFederatedData)
    assert wrapped.data.rounds is data.rounds and wrapped.data.prefetch == 2
    assert torch.device(wrapped.data.device).type == "cuda"
    init = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    wrapped.data = dataclasses.replace(wrapped.data, device="cpu")
    a = wrapped.run(4, state=tree_map(torch.clone, init))
    b = RoundDriver(fed, data, 3, log_every=0, verbose=False).run(4, state=init)
    assert a.history == b.history and _same_state(a.state, b.state)
    assert a.timings["data_kind"] == "stream"


# ---------------------------------------------------------------------------
# the slice against the JAX reference
# ---------------------------------------------------------------------------


class _GivenRounds(FederatedData):
    """A stream that yields given round batches (the reference's)."""

    kind = "stream"
    device = "cpu"

    def __init__(self, rounds):
        self.rounds = rounds

    def iter_rounds(self, rng, n_rounds):
        return iter(self.rounds[:n_rounds])


def _jax_grads(jfed_, start, batches):
    """Each agent's first-step (disc, gen) gradients in the reference."""
    B = jfed_.cfg.num_agents
    flat = lambda t, lead: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.asarray(x).reshape((B,) + np.shape(x)[lead:]), t)
    key = jax.random.key(0)

    def grads(p, bt):
        gd = jax.grad(lambda d: jfed_.task.disc_loss({**p, "disc": d}, bt, key))(p["disc"])
        gg = jax.grad(lambda g: jfed_.task.gen_loss({**p, "gen": g}, bt, key))(p["gen"])
        return {"disc": gd, "gen": gg}

    first = {k: v[0] for k, v in batches.items()}
    return jax.device_get(jax.vmap(grads)(flat(start["params"], 2), flat(first, 2)))


@pytest.mark.parametrize("name", ["toy_2d", "mixed_gaussian"])
def test_stream_slice_matches_the_reference(name):
    """The reference's ``RoundDriver`` stream run (2 rounds, K = 5) against
    the port's stream run over the reference's own round batches, round by
    round from the reference's state: every round within
    ``round_mismatches``, and the port's streamed round of the same keys
    over the same agent data gathers the reference's real samples."""
    K, n_rounds = 5, 2
    jspec, _ = jtrain.experiment_spec(name, K=K, steps=K * n_rounds, seed=0, log_every=0,
                                      samples_per_agent=256, batch_size=16)
    jf, jrounds = jspec.build()
    jstate = jf.init_state(jax.random.key(0))
    states = [jax.device_get(jstate)]

    def keep(fed, st, r):
        states.append(jax.device_get(st))
        return {}

    jres = jdriver.RoundDriver(jf, jfed.StreamingFederatedData(jrounds), n_rounds,
                               log_every=0, verbose=False, eval_every=1,
                               eval_hooks=(keep,)).run(jax.random.key(1), state=jstate)
    keys = jfed.round_key_schedule(jax.random.key(1), n_rounds)
    batches = [jax.device_get(jrounds.round_batches(k)[0]) for k in keys]

    tspec, _ = ttrain.experiment_spec(name, K=K, steps=K * n_rounds, log_every=0,
                                      device="cpu", samples_per_agent=256, batch_size=16)
    tf = tspec.build()
    exp = tpaper.ALL_EXPERIMENTS[name]
    for r in range(n_rounds):
        given = _GivenRounds([(from_jax_params(batches[r], device="cpu"), None)])
        got = RoundDriver(tf, given, 1, log_every=0, verbose=False).run(
            0, state=from_jax_params(states[r], device="cpu"))
        assert got.timings["data_kind"] == "stream"
        want = states[r + 1]
        grads = _jax_grads(jf, states[r], batches[r])
        shift = lambda s: {**s, "step": np.asarray(s["step"]) - r * K}  # noqa: E731
        losses = ((got.history[0]["d_loss"], got.history[0]["g_loss"]),
                  (jres.history[r]["d_loss"], jres.history[r]["g_loss"]))
        bad, _ = round_mismatches(exp, K, shift(to_jax_params(got.state)), shift(want),
                                  grads, losses)
        assert bad == [], (r, bad[:5])

    # the port's own stream over the same agent data gathers the same samples
    agents = [{k: torch.from_numpy(np.array(v)) for k, v in d.items()}
              for d in jrounds.agent_data]
    ours = FederatedRounds(agents, jrounds.agent_grid, jrounds.batch_size, K,
                           sample_extra=tspec.sample_extra)
    for k, b in zip(stream_key_schedule(prng.key(1), n_rounds), batches):
        tb, _ = ours.round_batches(k)
        assert np.array_equal(tb["x"].numpy(), np.asarray(b["x"]))


def test_fedgan_weights_go_to_the_device_once():
    """Given ``weights`` are normalised and placed once per device: the
    values are the old per-round ``w / sum(w)``, and later rounds reuse
    the same tensor (no host-to-device copy a round)."""
    spec, _ = ttrain.experiment_spec("toy_2d", K=2, steps=4, log_every=0, device="cpu")
    w = np.array([[1.0, 2.0, 3.0, 4.0, 6.0]], np.float32)
    fed = dataclasses.replace(spec.build(), weights=w)
    first = fed._w("cpu")
    want = torch.as_tensor(w, dtype=torch.float32)
    assert torch.equal(first, want / torch.sum(want))
    assert fed._w(torch.device("cpu")) is first
    state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    res = RoundDriver(fed, spec.build_data(), 2, log_every=0, verbose=False).run(0, state=state)
    assert fed._w("cpu") is first and np.isfinite(res.history[-1]["d_loss"])
    assert dataclasses.replace(fed)._w("cpu") is not first


def test_train_cli_streams(capsys):
    """``--data-mode stream`` on the train CLI runs the host pipeline."""
    result = ttrain.main(["--experiment", "toy_2d", "--device", "cpu", "--K", "2",
                          "--steps", "4", "--samples-per-agent", "64", "--log-every", "0",
                          "--data-mode", "stream"])
    assert result.timings["data_kind"] == "stream" and len(result.history) == 2
    assert '"data_kind": "stream"' in capsys.readouterr().out


def test_sweep_takes_rounds_per_chunk(tmp_path):
    """The sweep runs 8 rounds a chunk by default, as the reference's;
    ``--rounds-per-chunk`` sets it, and on the CPU the chunks change no
    bit."""
    from repro_torch.run.experiments import main, run_sweep
    a = run_sweep("toy_2d", [2], steps=16, out_dir=str(tmp_path), eval_n=64,
                  verbose=False, device="cpu")
    b = main(["--experiment", "toy_2d", "--sweep", "K=2", "--steps", "16", "--eval-n", "64",
              "--out-dir", str(tmp_path), "--device", "cpu", "--rounds-per-chunk", "1"])
    assert a[0].history == b[0].history and a[0].final == b[0].final
    assert os.path.exists(tmp_path / "sweep_toy_2d.jsonl")


@pytest.mark.parametrize("name", sorted(tpaper.ALL_EXPERIMENTS))
def test_every_experiment_streams(name):
    """Every paper experiment runs on the host-streaming pipeline: finite
    losses, the agents synced after each round, and its rounds' real
    samples drawn from each agent's own shard."""
    spec, _ = ttrain.experiment_spec(name, K=1, steps=2, batch_size=4, log_every=0,
                                     samples_per_agent=32, device="cpu", data_mode="stream")
    result = spec.run_result()
    assert result.timings["data_kind"] == "stream" and len(result.history) == 2
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    for x in tree_leaves(result.state["params"]):
        assert torch.equal(x, x[:1, :1].expand_as(x))
    data = spec.build_data()
    batches, _ = data.rounds.round_batches(prng.key(0))
    for a, shard in enumerate(data.rounds.agent_data):
        rows = shard["x"].reshape(shard["x"].shape[0], -1)
        got = batches["x"][:, 0, a].reshape(-1, rows.shape[1])
        assert all((rows == row).all(1).any() for row in got)


@pytest.mark.parametrize("data_mode", ["device", "stream"])
def test_driver_does_not_pin_the_initial_state(data_mode):
    """``RoundDriver.run`` and ``RunSpec.run_result`` keep no reference to
    the initial state: after the first round it is freed (by reference
    count, the collector off), as every later round's input is, so a run
    holds at most the round's input and output states, not the initial one
    as well: at a backbone's width, as large as the live state."""
    import gc
    import weakref
    from repro_torch.tree import tree_leaves
    spec, _ = ttrain.experiment_spec("toy_2d", K=1, steps=3, batch_size=4, log_every=0,
                                     samples_per_agent=16, device="cpu", data_mode=data_mode)
    fed = spec.build()
    refs, alive = [], []

    def watched(state):
        refs.extend(weakref.ref(x) for x in tree_leaves(state["opt_g"]) + [state["step"]])
        return state

    def hook(fed_, state, r):
        alive.append(any(ref() is not None for ref in refs))
        return {}

    driver = RoundDriver(fed, spec.build_data(), 3, log_every=0, eval_every=1,
                         eval_hooks=(hook,), verbose=False)
    # a process's first local step leaves its input in a garbage cycle once
    # (torch's first-call set-up keeps a list of frames); take it first
    driver.run(1)
    alive.clear()
    gc.collect()
    gc.disable()
    try:
        driver.run(1, state=watched(fed.init_state(torch.Generator().manual_seed(0),
                                                   device="cpu")))
    finally:
        gc.enable()
    assert alive == [False, False, False]
