"""The port's codecs, the composed coded sync and the slice's strategies
against the JAX reference, on the CPU.

Tolerances, with their reasons:

* Codecs (``IntQuant``, ``TopK``, ``Sequential``) are elementwise or
  selections: payloads, indices, scales and decoded values are
  bit-identical, ties of ``TopK`` included (the lower index first, as
  ``jax.lax.top_k``).
* ``coded_sync(fused=False)``: the uplink (EF add, encode, decode) is
  elementwise, so ``new_ef`` is bit-identical.  ``synced`` and
  ``new_ef_down`` follow the weighted reduce over the agents, which the
  two packages may group in another order: a last-bit difference of the
  mean may move a downlink code across a rounding boundary (or the
  block's max-abs, and with it the scale), so they get one quantum of
  their downlink block.  Under ``TopK`` such a difference may also swap
  which of two entries at the k-th magnitude is kept, so entries within a
  float32 rounding of the k-th magnitude are exempt.
* A round: as ``test_torch_round.py`` (float32 roundoff of two SGD steps
  through the library convolutions, 1e-5 of each leaf's magnitude; one
  quantum of the leaf's coarsest block on at most 2% of the elements).
  Under ``TopK`` the roundoff of the local steps may also swap the entries
  kept at a near-tie of the k-th magnitude; the value there changes by up
  to the kept magnitude, bounded by the leaf's largest value, on at most
  1e-4 of the elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_qpack import _assert_bits_equal, qpack_stream
from torch_shared import (GRID, K, _batches, _strategy_pair, coarsest_quanta,  # noqa: F401
                          one_torch_thread)

from repro.comm import codecs as jcodecs
from repro.core import strategies as jstrategies
from repro.dist import collectives as jcoll

from repro_torch.comm import codecs as tcodecs
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import strategies as tstrategies
from repro_torch.dist import collectives as tcoll
from repro_torch.kernels.qpack.ref import _wire_scale
from repro_torch.kernels.qsync import ops as tqsync
from repro_torch.launch import train
from repro_torch.tree import tree_leaves


def _codec_pair(spec, **kw):
    """The same codec in both packages, from the shared spec grammar."""
    return jcodecs.get_codec(spec, **kw), tcodecs.get_codec(spec, **kw)


def _tree_np(t):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]


def _assert_trees_bits_equal(got, want):
    g, w = [x.numpy() for x in tree_leaves(got)], _tree_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _assert_bits_equal(a, b)


def _ties(rng, lead, n):
    """Streams full of equal magnitudes: zeros, +-1 and +-0.5, a few
    distinct values among them."""
    x = rng.choice(np.float32([0.0, 1.0, -1.0, 0.5, -0.5]), lead + (n,))
    x[..., ::7] = rng.standard_normal(lead + (len(range(0, n, 7)),))
    return x.astype(np.float32)


SPECS = ["int8", "int4", "topk", "topk+int8", "topk+int4"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("ties", [False, True], ids=["mixed", "ties"])
def test_codec_encode_decode_roundtrip_match_jax(spec, ties):
    """encode's payload and meta, decode and roundtrip, on a (2, 3) agent
    batch of 1000-long leaves (not a block multiple), at fraction 0.25."""
    jc, tc = _codec_pair(spec, fraction=0.25)
    rng = np.random.default_rng(len(spec) + ties)
    x = (_ties(rng, (2, 3), 1000) if ties
         else qpack_stream(rng, (2, 3), 1000, 128, 4)).reshape(2, 3, 10, 100)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jp, jm = jc.encode(jx, 2)
    tp, tm = tc.encode(tx, 2)
    _assert_bits_equal(tp, jp)
    _assert_trees_bits_equal(tm, jm)
    like_j = jax.ShapeDtypeStruct(x.shape[2:], jnp.float32)
    like_t = tcodecs.Like(x.shape[2:], torch.float32)
    _assert_bits_equal(tc.decode(tp, tm, like_t, 2), jc.decode(jp, jm, like_j, 2))
    _assert_bits_equal(tc.roundtrip(tx, 2), jc.roundtrip(jx, 2))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 400), frac=st.floats(0.01, 1.0), seed=st.integers(0, 99))
def test_topk_matches_jax_at_ties(n, frac, seed):
    """The selection is jax.lax.top_k's: the same values and the same
    indices, lower index first among equal magnitudes."""
    x = _ties(np.random.default_rng(seed), (3,), n)
    jv, jm = jcodecs.TopK(frac).encode(jnp.asarray(x), 1)
    tv, tm = tcodecs.TopK(frac).encode(torch.from_numpy(x), 1)
    _assert_bits_equal(tv, jv)
    _assert_bits_equal(tm["idx"], jm["idx"])


def test_sequential_validates_and_bills_like_jax():
    for spec in ("topk+int8", "topk+int4"):
        jc, tc = _codec_pair(spec, fraction=0.1)
        assert tc.name == jc.name and tc.chainable == jc.chainable
        for n in (1, 127, 1000, 4097):
            assert tc.wire_bytes(tcodecs.Like((n,), torch.float32)) == \
                jc.wire_bytes(jax.ShapeDtypeStruct((n,), jnp.float32))
    with pytest.raises(ValueError, match="last stage"):
        tcodecs.Sequential((tcodecs.IntQuant(8), tcodecs.TopK())).validate()
    with pytest.raises(ValueError, match="at least one"):
        tcodecs.Sequential(()).validate()


# ---------------------------------------------------------------------------
# billed bytes, registry, flags
# ---------------------------------------------------------------------------


BILLED = [("int8", 0.0, False), ("int4", 0.0, False), ("topk", 0.0, False),
          ("topk+int8", 0.0, False), ("int4", 0.25, False), ("int4", 0.25, True)]


@pytest.fixture(scope="module")
def acgan_states():
    """The image experiment's ACGAN state (16x16 nets, two agents) in both
    packages."""
    jfed, _, _ = _strategy_pair("adam", None, None, hw=16, grid=(1, 2))
    jstate = jfed.init_state(jax.random.key(0))
    return jstate, from_jax_params(jax.device_get(jstate), device="cpu")


@pytest.mark.parametrize("spec,topk,opt_state", BILLED)
def test_billed_bytes_match_jax_on_the_acgan_tree(acgan_states, spec, topk, opt_state):
    """comm_bytes_per_round for every codec and chain of the CLI, on the
    image experiment's nets, the optimizer moments too when they ride the
    wire."""
    jstate, tstate = acgan_states
    jc = jcodecs.codec_from_flags(spec, topk=topk)
    tc = tcodecs.codec_from_flags(spec, topk=topk)
    assert tc.name == jc.name
    jfed, tfed, _ = _strategy_pair(
        "adam", jstrategies.FedAvgSync(codec=jc, average_opt_state=opt_state),
        tstrategies.FedAvgSync(codec=tc, average_opt_state=opt_state),
        hw=16, grid=(1, 2))
    want = jfed.comm_bytes_per_round(jstate)
    assert tfed.comm_bytes_per_round(tstate) == want
    assert want["strategy_bytes_per_round"] < want["per_agent_per_round"]["fedgan"]


def test_registry_and_flag_resolution():
    """The cases of the reference's ``test_registry_and_flag_resolution``."""
    IQ, TK, SQ = tcodecs.IntQuant, tcodecs.TopK, tcodecs.Sequential
    assert tcodecs.get_codec("int8") == IQ(bits=8)
    assert tcodecs.get_codec("topk+int8", fraction=0.25, bits=8) == \
        SQ((TK(fraction=0.25), IQ(bits=8)))
    with pytest.raises(ValueError, match="unknown codec"):
        tcodecs.get_codec("bogus")
    assert tcodecs.codec_from_flags() is None
    assert tcodecs.codec_from_flags("int4") == IQ(bits=4)
    assert tcodecs.codec_from_flags("", bits=4) == IQ(bits=4)
    assert tcodecs.codec_from_flags("", topk=0.05) == TK(fraction=0.05)
    assert tcodecs.codec_from_flags("int8", topk=0.25) == \
        SQ((TK(fraction=0.25), IQ(bits=8)))
    for bad in (IQ(bits=3), IQ(block=7), TK(fraction=0.0)):
        with pytest.raises(ValueError):
            bad.validate()
    assert sorted(tcodecs.CODECS) == sorted(jcodecs.CODECS)


def _args(*argv):
    return train.build_parser().parse_args(["--experiment", "image_acgan", *argv])


def test_cli_codec_and_strategy_flags():
    """The cases of the reference's ``test_cli_codec_flags`` that the port
    supports, with the reference's messages."""
    IQ, TK, SQ = tcodecs.IntQuant, tcodecs.TopK, tcodecs.Sequential
    strat = train.strategy_from_args(_args("--codec", "int8"))
    assert isinstance(strat, tstrategies.FedAvgSync) and strat.codec == IQ(bits=8)
    strat = train.strategy_from_args(_args("--strategy", "partial_sharing",
                                           "--codec", "int4"))
    assert isinstance(strat, tstrategies.PartialSharing)
    assert strat.codec == IQ(bits=4) and strat.subtrees == ("gen",)
    strat = train.strategy_from_args(_args("--codec", "int4", "--topk", "0.25"))
    assert strat.codec == SQ((TK(fraction=0.25), IQ(bits=4)))
    strat = train.strategy_from_args(_args("--codec", "topk+int8", "--codec-bits", "4"))
    assert strat.codec == SQ((TK(), IQ(bits=4)))
    strat = train.strategy_from_args(_args("--average-opt-state"))
    assert strat == tstrategies.FedAvgSync(average_opt_state=True)
    assert train.strategy_from_args(_args()) is None
    with pytest.raises(ValueError, match="does not accept"):
        train.strategy_from_args(_args("--strategy", "local_only", "--codec", "int8"))
    assert tcodecs.codec_from_flags("int8+") == IQ(bits=8)
    with pytest.raises(ValueError, match="empty codec spec"):
        tcodecs.codec_from_flags("+")
    with pytest.raises(ValueError, match="empty codec spec"):
        train.strategy_from_args(_args("--codec", "+"))
    # the messages are the reference's own
    from repro.launch.train import build_parser as jparser, strategy_from_args as jfrom
    with pytest.raises(ValueError, match="does not accept"):
        jfrom(jparser().parse_args(["--experiment", "image_acgan", "--strategy",
                                    "local_only", "--codec", "int8"]))
    with pytest.raises(ValueError, match="empty codec spec"):
        jcodecs.codec_from_flags("+")


def test_strategy_registry_holds_the_ported_strategies():
    assert set(tstrategies.STRATEGIES) <= set(jstrategies.STRATEGIES)
    for name, cls in tstrategies.STRATEGIES.items():
        assert cls.__name__ == jstrategies.STRATEGIES[name].__name__
        assert tstrategies.get_strategy(name).name == jstrategies.get_strategy(name).name
    assert tstrategies.get_strategy("partial_sharing", codec=tcodecs.IntQuant(8)) == \
        tstrategies.PartialSharing(codec=tcodecs.IntQuant(8))
    assert tstrategies.get_strategy("median") == tstrategies.CoordinateMedianSync()
    assert train.strategy_from_args(_args("--strategy", "median", "--codec", "int8")) == \
        tstrategies.CoordinateMedianSync(codec=tcodecs.IntQuant(8))
    with pytest.raises(ValueError, match="known: .*partial_sharing"):
        tstrategies.get_strategy("krum")
    with pytest.raises(SystemExit):   # argparse's choices: the registry's names
        _args("--strategy", "krum")


def test_fedavg_sync_validation_of_codecs():
    cfg = None
    with pytest.raises(ValueError, match="last stage"):
        tstrategies.FedAvgSync(codec=tcodecs.Sequential(
            (tcodecs.IntQuant(8), tcodecs.TopK()))).validate(cfg)
    with pytest.raises(ValueError, match="fused_sync_spec"):
        tstrategies.FedAvgSync(codec=tcodecs.get_codec("topk+int4"),
                               fused_sync=True).validate(cfg)
    with pytest.raises(ValueError, match="needs a codec"):
        tstrategies.FedAvgSync(fused_sync=True).validate(cfg)
    tstrategies.FedAvgSync(codec=tcodecs.get_codec("topk+int4")).validate(cfg)
    tstrategies.FedAvgSync(codec=tcodecs.IntQuant(4), fused_sync=True).validate(cfg)


# ---------------------------------------------------------------------------
# coded_sync
# ---------------------------------------------------------------------------


SHAPES = {"a": (3, 50), "b": (129,), "c": (4, 4, 2, 8), "d": (1,), "e": (1000,)}


def _sync_inputs(grid, seed, dtypes=None):
    rng = np.random.default_rng(seed)
    w = rng.random(grid).astype(np.float32) + 0.1
    w /= w.sum()
    tree = {k: (rng.standard_normal(grid + s)
                * rng.choice([1e-3, 1.0, 30.0], grid + s)).astype(np.float32)
            for k, s in SHAPES.items()}
    ef = {k: (0.01 * rng.standard_normal(grid + s)).astype(np.float32)
          for k, s in SHAPES.items()}
    ed = {k: (0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    tree["n"], ef["n"], ed["n"] = (np.full(grid, 3, np.int32), np.zeros(grid, np.int32),
                                   np.zeros((), np.int32))
    return w, tree, ef, ed


def _to_j(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _to_t(t):
    return {k: torch.from_numpy(v) for k, v in t.items()}


def _downlink_quantum(yd, codec):
    """Per element of the downlink stream yd, the quantum of its block (the
    stream the quantizer sees: yd itself, or its top-k values)."""
    quant = codec.codecs[-1] if isinstance(codec, tcodecs.Sequential) else codec
    qmax = 2 ** (quant.bits - 1) - 1
    flat = np.abs(yd.reshape(-1))
    if isinstance(codec, tcodecs.Sequential):
        flat = np.sort(flat)[::-1][:codec.codecs[0]._k(flat.size)]
    pad = (-flat.size) % quant.block
    blocks = np.pad(flat, (0, pad)).reshape(-1, quant.block)
    _, s = _wire_scale(torch.from_numpy(blocks.max(-1, keepdims=True)), qmax)
    return float(s.max())


def _near_kth(yd, codec):
    """Entries of yd within a float32 rounding of its k-th magnitude."""
    if not isinstance(codec, tcodecs.Sequential):
        return np.zeros(yd.shape, bool)
    mag = np.abs(yd)
    kth = np.sort(mag.reshape(-1))[::-1][codec.codecs[0]._k(mag.size) - 1]
    return np.abs(mag - kth) <= 4 * np.spacing(np.float32(kth))


@pytest.mark.parametrize("spec", ["int8", "int4", "topk+int4"])
def test_composed_coded_sync_matches_jax(spec):
    """coded_sync(fused=False) on a (2, 2) grid with non-uniform weights
    and error feedback; an integer leaf passes through."""
    jc, tc = _codec_pair(spec, fraction=0.25)
    w, tree, ef, ed = _sync_inputs((2, 2), seed=len(spec))
    want = jcoll.coded_sync(_to_j(tree), jnp.asarray(w), jc, ef=_to_j(ef),
                            ef_down=_to_j(ed), fused=False)
    got = tcoll.coded_sync(_to_t(tree), torch.from_numpy(w), tc, ef=_to_t(ef),
                           ef_down=_to_t(ed), fused=False)
    for k in SHAPES:
        _assert_bits_equal(got[1][k], want[1][k])
        synced, ned = got[0][k].numpy(), got[2][k].numpy()
        wsynced, wned = np.asarray(want[0][k]), np.asarray(want[2][k])
        assert synced.shape == wsynced.shape and (synced == synced[:1, :1]).all()
        yd = wsynced[0, 0] + wned
        q = _downlink_quantum(yd, tc)
        free = _near_kth(yd, tc)
        for g, wt in ((synced[0, 0], wsynced[0, 0]), (ned, wned)):
            assert np.all((np.abs(g - wt) <= q) | free), (k, np.abs(g - wt).max(), q)
    for i in range(3):
        np.testing.assert_array_equal(got[i]["n"].numpy(), np.asarray(want[i]["n"]))


def test_non_f32_leaf_falls_back_to_the_composed_loop():
    """Under the fused default a bfloat16 leaf takes the composed pipeline
    (the codec's roundtrip around the weighted mean), its float32
    neighbours the bucketed fused sync."""
    codec = tcodecs.IntQuant(8)
    w, tree, ef, ed = _sync_inputs((1, 5), seed=3)
    t, e, d = _to_t(tree), _to_t(ef), _to_t(ed)
    t["a"], e["a"], d["a"] = (t["a"].to(torch.bfloat16), e["a"].to(torch.bfloat16),
                              d["a"].to(torch.bfloat16))
    tw = torch.from_numpy(w)
    synced, ne, ned = tcoll.coded_sync(t, tw, codec, ef=e, ef_down=d)
    y = t["a"] + e["a"]
    q = codec.roundtrip(y, batch_ndims=2)
    yd = tcoll.weighted_mean(q, tw) + d["a"]
    qd = codec.roundtrip(yd)
    assert synced["a"].dtype == torch.bfloat16
    assert torch.equal(synced["a"], qd.expand(y.shape))
    assert torch.equal(ne["a"], y - q) and torch.equal(ned["a"], yd - qd)
    keys = [k for k in SHAPES if k != "a"]
    f_out, f_ne, f_ned = tqsync.qsync_leaves([t[k] for k in keys], tw,
                                             [e[k] for k in keys],
                                             [d[k] for k in keys], bits=8, block=128)
    for k, o, a, b in zip(keys, f_out, f_ne, f_ned):
        assert torch.equal(synced[k], o) and torch.equal(ne[k], a) and torch.equal(ned[k], b)


def test_fused_true_refuses_a_codec_without_a_spec():
    w, tree, _, _ = _sync_inputs((1, 2), seed=4)
    with pytest.raises(ValueError, match="fused_sync_spec"):
        tcoll.coded_sync(_to_t(tree), torch.from_numpy(w),
                         tcodecs.get_codec("topk+int4"), fused=True)
    with pytest.raises(ValueError, match="fused_sync_spec"):
        jcoll.coded_sync(_to_j(tree), jnp.asarray(w), jcodecs.get_codec("topk+int4"),
                         fused=True)


@pytest.mark.parametrize("bits", [4, 8])
def test_composed_matches_fused_on_the_cpu(bits):
    """The port's two paths at grid (1, 2), where the two-term reduce has
    one order: bit-identical, zeros' signs included."""
    codec = tcodecs.IntQuant(bits)
    w, tree, ef, ed = _sync_inputs((1, 2), seed=bits)
    args = (_to_t(tree), torch.from_numpy(w), codec)
    fused = tcoll.coded_sync(*args, ef=_to_t(ef), ef_down=_to_t(ed), fused=True)
    composed = tcoll.coded_sync(*args, ef=_to_t(ef), ef_down=_to_t(ed), fused=False)
    for f, c in zip(fused, composed):
        _assert_trees_bits_equal(f, {k: v.numpy() for k, v in c.items()})


# ---------------------------------------------------------------------------
# the slice end to end: one ACGAN round
# ---------------------------------------------------------------------------


ROUNDS = {
    "topk_int4": (lambda: jstrategies.FedAvgSync(codec=jcodecs.get_codec(
                      "topk+int4", fraction=0.25)),
                  lambda: tstrategies.FedAvgSync(codec=tcodecs.get_codec(
                      "topk+int4", fraction=0.25)), 7),
    "partial_int8": (lambda: jstrategies.PartialSharing(codec=jcodecs.IntQuant(8)),
                     lambda: tstrategies.PartialSharing(codec=tcodecs.IntQuant(8)), 127),
}


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_composed_round_matches_jax(case):
    """One ACGAN round (8x8 images, B = 5, K = 2, SGD) from the same
    converted state and batches as ``test_torch_round.py``."""
    jstrat, tstrat, qmax = ROUNDS[case]
    jfed, tfed, _ = _strategy_pair("sgd", jstrat(), tstrat())
    jstate = jfed.init_state(jax.random.key(0))
    batches = _batches(np.random.default_rng(0))
    start = from_jax_params(jax.device_get(jstate), device="cpu")
    tbatches = from_jax_params(batches, device="cpu")
    tstate, _ = tfed.round(start, tbatches)
    quanta = coarsest_quanta(tfed, start, tbatches, qmax)
    jstate, _ = jax.jit(jfed.round)(jstate, _to_j(batches),
                                    jnp.zeros((K,) + GRID, jnp.uint32))
    want, got = jax.device_get(jstate), to_jax_params(tstate)
    assert sorted(got) == sorted(want) and sorted(got["ef"]) == sorted(tstrat().subtrees)
    over = swaps = total = 0
    for key in ("params", "ef", "ef_down"):
        for sub in sorted(want[key]):
            for i, (g, wt) in enumerate(zip(_tree_np(got[key][sub]),
                                            _tree_np(want[key][sub]))):
                if key == "params" and sub in tstrat().subtrees:
                    assert (g == g[:1, :1]).all()   # every agent holds the synced value
                tol = 1e-5 * max(1.0, float(np.abs(wt).max()))
                q = quanta[sub][i] if sub in quanta else 0.0
                diff = np.abs(g - wt)
                big = diff > tol + q
                swaps += int(big.sum())
                assert np.all(diff[big] <= tol + q + quanta.get(sub, [0.0] * (i + 1))[i]
                              * qmax), (key, sub, i, float(diff.max()))
                over += int((diff > tol).sum())
                total += diff.size
    assert over <= 0.02 * total, (over, total)
    assert swaps <= (1e-4 * total if case == "topk_int4" else 0), (swaps, total)
