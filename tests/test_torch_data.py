"""The port's round data pipelines against the JAX reference, on the CPU:
the Threefry ``split`` and ``randint`` bits, the non-iid partitioners,
the host-streaming assembler (``FederatedRounds``), the prefetching
stream, and the device pipeline's draw/gather split.

Tolerances: none.  Every comparison here is bit for bit (the same
integer arithmetic, the same numpy ``RandomState`` draws, the same
gathers), except the ``sample_extra`` draws of a streamed round, which the
port draws from a host ``torch.Generator`` (the reference's
``jax.random.normal`` bits are not reproduced): those are held to their
shape and to being the same for the same key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_shared import one_torch_thread  # noqa: F401

from repro.data import federated as jfed

from repro_torch import prng
from repro_torch.data import (DeviceFederatedData, FederatedRounds,
                              StreamingFederatedData, dirichlet_partition,
                              label_shard_partition, partition_sizes,
                              stream_key_schedule)

SPANS = [(0, 1), (0, 2), (0, 7), (0, 64), (3, 1000), (0, 4096), (0, 100_003),
         (-5, 5), (5, 5), (9, 2), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)]


# ---------------------------------------------------------------------------
# Threefry: split and randint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_split_matches_jax(seed, n):
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), n)))
    got = prng.split(prng.key(seed), n)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("shape", [(1,), (5,), (4, 16), (2, 1, 5)])
def test_randint_matches_jax(shape, lo, hi):
    """Spans that are and are not powers of two, n = 1, an empty range
    (minval returned) and the widest int32 range."""
    for seed in (0, 3, 99):
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
        got = prng.randint(prng.key(seed), shape, lo, hi)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), (seed, shape, lo, hi)


@settings(deadline=None, max_examples=40)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 100_000),
       rows=st.integers(1, 6), cols=st.integers(1, 40))
def test_randint_matches_jax_property(seed, n, rows, cols):
    k = jax.random.fold_in(jax.random.key(seed), n)
    want = np.asarray(jax.random.randint(k, (rows, cols), 0, n))
    got = prng.randint(prng.fold_in(prng.key(seed), n), (rows, cols), 0, n)
    assert np.array_equal(got, want)


def test_randint_refuses_bounds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.key(0), (2,), 0, 2 ** 31)


def test_random_bits_takes_a_shape():
    k = jax.random.key(4)
    want = np.asarray(jax.random.bits(k, (3, 5), jnp.uint32))
    assert np.array_equal(prng.random_bits(prng.key(4), (3, 5)), want)
    assert np.array_equal(prng.random_bits(prng.key(4), 15), want.reshape(-1))


def test_stream_key_schedule_matches_the_reference():
    want = jfed.round_key_schedule(jax.random.key(11), 6)
    got = stream_key_schedule(prng.key(11), 6)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(jax.random.key_data(w)))


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------


def _labels(seed, n=600, classes=10):
    return np.random.default_rng(seed).integers(0, classes, n)


@pytest.mark.parametrize("num_agents", [1, 3, 5, 7])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_label_shard_partition_matches_reference(num_agents, seed):
    labels = _labels(seed)
    want = jfed.label_shard_partition(labels, num_agents, seed=seed)
    for as_tensor in (False, True):
        got = label_shard_partition(torch.from_numpy(labels) if as_tensor else labels,
                                    num_agents, seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("alpha", [0.1, 0.3, 5.0])
@pytest.mark.parametrize("num_agents", [2, 5])
@pytest.mark.parametrize("seed", [0, 3])
def test_dirichlet_partition_matches_reference(alpha, num_agents, seed):
    labels = _labels(seed, n=400, classes=6)
    want = jfed.dirichlet_partition(labels, num_agents, alpha=alpha, seed=seed)
    got = dirichlet_partition(labels, num_agents, alpha=alpha, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and np.array_equal(g.numpy(), np.asarray(w))
    assert sorted(np.concatenate([g.numpy() for g in got]).tolist()) == list(range(400))


def test_partition_sizes_match_reference():
    parts = label_shard_partition(_labels(2), 4, seed=2)
    want = np.asarray(jfed.partition_sizes(jfed.label_shard_partition(_labels(2), 4, seed=2)))
    got = partition_sizes(parts)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# host-streaming rounds
# ---------------------------------------------------------------------------


def _timeseries_agents(sizes=(37, 50, 29, 64), seed=0):
    """timeseries_cgan's layout: 24-step profiles and one-hot climate
    zones, one shard per agent, of other sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        out.append({"x": rng.standard_normal((n, 24)).astype(np.float32),
                    "y": np.eye(5, dtype=np.float32)[np.full(n, i % 5)]})
    return out


def _pair(agents, grid, batch, K):
    jrounds = jfed.FederatedRounds(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in agents], grid, batch, K,
        sample_extra=lambda r, s: {"z": jax.random.normal(r, s + (24,))})
    trounds = FederatedRounds(
        [{k: torch.from_numpy(v) for k, v in d.items()} for d in agents], grid, batch, K,
        sample_extra=lambda g, s: {"z": torch.randn(s + (24,), generator=g)})
    return jrounds, trounds


@pytest.mark.parametrize("grid,K,batch", [((1, 4), 3, 8), ((2, 2), 1, 16), ((4, 1), 5, 4)])
def test_round_batches_match_the_reference(grid, K, batch):
    """The real-data leaves (profiles and labels) and the uint32 seeds of
    a streamed round are the reference's bit for bit for the same agent
    data and key; the z draws have the reference's shape and repeat for
    the same key."""
    jrounds, trounds = _pair(_timeseries_agents(), grid, batch, K)
    for seed in (0, 5):
        for jk, tk in zip(jfed.round_key_schedule(jax.random.key(seed), 3),
                          stream_key_schedule(prng.key(seed), 3)):
            (jb, js), (tb, ts) = jrounds.round_batches(jk), trounds.round_batches(tk)
            assert sorted(tb) == sorted(jb) == ["x", "y", "z"]
            for k in ("x", "y"):
                assert tb[k].dtype == torch.float32
                assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k
            assert ts.dtype == torch.uint32 and np.array_equal(ts.numpy(), np.asarray(js))
            assert tuple(tb["z"].shape) == tuple(jb["z"].shape)
            again, _ = trounds.round_batches(tk)
            assert torch.equal(again["z"], tb["z"])


def test_round_batches_into_given_buffers_match():
    _, trounds = _pair(_timeseries_agents(), (2, 2), 8, 3)
    k = prng.key(3)
    want = trounds.round_batches(k)
    out = ({x: torch.full_like(v, -7.0) for x, v in want[0].items()},
           torch.zeros_like(want[1]))
    got = trounds.round_batches(k, out=out)
    assert all(got[0][x] is out[0][x] for x in out[0]) and got[1] is out[1]
    assert all(torch.equal(got[0][x], want[0][x]) for x in want[0])
    assert torch.equal(got[1], want[1])


def test_streaming_prefetch_preserves_batch_stream():
    """Every prefetch depth yields exactly the batches of the blocking
    assembler, in order (the twin of the reference's test)."""
    agent_data = [{"x": torch.arange(40.0) + 100 * i} for i in range(4)]
    fr = FederatedRounds(agent_data, (2, 2), batch_size=8, sync_interval=3)
    rng = prng.key(9)
    want = [fr.round_batches(rb) for rb in stream_key_schedule(rng, 5)]
    jwant = jfed.FederatedRounds([{"x": jnp.arange(40.0) + 100 * i} for i in range(4)],
                                 (2, 2), 8, 3)
    for (wb, ws), jk in zip(want, jfed.round_key_schedule(jax.random.key(9), 5)):
        jb, js = jwant.round_batches(jk)
        assert np.array_equal(wb["x"].numpy(), np.asarray(jb["x"]))
        assert np.array_equal(ws.numpy(), np.asarray(js))
    for prefetch in (1, 2, 4, 8):
        got = list(StreamingFederatedData(fr, prefetch=prefetch, device="cpu")
                   .iter_rounds(rng, 5))
        assert len(got) == 5
        for (gb, gs), (wb, ws) in zip(got, want):
            assert torch.equal(gb["x"], wb["x"]) and torch.equal(gs, ws)


def test_stream_refuses_bad_prefetch_and_grids():
    fr = FederatedRounds([{"x": torch.arange(8.0)}] * 2, (1, 2), 2, 1)
    with pytest.raises(ValueError, match="prefetch"):
        next(StreamingFederatedData(fr, prefetch=0, device="cpu").iter_rounds(prng.key(0), 2))
    with pytest.raises(ValueError, match="agent_grid"):
        FederatedRounds([{"x": torch.arange(8.0)}] * 3, (1, 2), 2, 1)


def test_from_agent_data_moves_the_shards_to_the_host():
    data = StreamingFederatedData.from_agent_data(
        [{"x": torch.arange(6.0)}, {"x": torch.arange(9.0)}], (1, 2), 4, 2, device="cpu")
    assert data.kind == "stream" and data.agent_grid == (1, 2) and data.batch_size == 4
    (b, s), = list(data.iter_rounds(prng.key(1), 1))
    assert b["x"].shape == (2, 1, 2, 4) and s.shape == (2, 1, 2)
    assert (b["x"][:, 0, 0] < 6).all() and (b["x"][:, 0, 1] < 9).all()


# ---------------------------------------------------------------------------
# device-resident: the draws split from the gathers
# ---------------------------------------------------------------------------


def test_draw_then_gather_is_sample_step():
    """``gather_step(draw_step(gen))`` is ``sample_step(gen)`` bit for bit,
    and K steps' draws made up front consume the generator as K
    interleaved ``sample_step`` calls do."""
    shards = [{"x": torch.arange(n, dtype=torch.float32) + 100 * i}
              for i, n in enumerate((7, 12, 9))]
    data = DeviceFederatedData.from_agent_data(
        shards, (1, 3), 5, device="cpu",
        sample_extra=lambda g, s: {"z": torch.randn(s + (2,), generator=g)})
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    want = [data.sample_step(g1) for _ in range(3)]
    draws = [data.draw_step(g2) for _ in range(3)]
    for w, d in zip(want, draws):
        got = data.gather_step(d)
        assert sorted(got) == sorted(w) and all(torch.equal(got[k], w[k]) for k in w)
