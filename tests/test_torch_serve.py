"""The port's serving package on the CPU against the JAX reference's
(``repro.serve``): the bucketing and layout policy, the batcher, the cache
surgery of ``insert_slot`` bit for bit on the same numpy cache trees, the
engine's tokens against per-request greedy decode and against the
reference's engine on the same params (greedy and sampled), hot reload,
and the ``serve_generator`` CLI.

Tolerances: none.  Tokens, buckets, index maps and cache writes are
compared exactly; a token is the argmax of logits that agree with the
reference's within 1e-5 (``tests/test_torch_backbone.py``), and on these
configs no step is that close to a tie.  The configs are the reference's
serving test configs (``tests/test_serve.py``) and ``tests/test_models.py``'s
hybrid; an audio request carries its own seeded encoder frames, the same
numpy array in both packages.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models import CFGS as JMODEL_CFGS
from test_serve import CFGS as JSERVE_CFGS, WORK, _fedgan_style_state as _jstate
from test_torch_backbone import port_config
from torch_shared import one_torch_thread  # noqa: F401

import repro.serve as jserve
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.models.transformer import Backbone as JBackbone
from repro.serve import ServeEngine as JServeEngine
from repro.serve import cache as jcache

import repro_torch.serve as tserve
from repro_torch.checkpoint import save_checkpoint
from repro_torch.convert import backbone_params_from_jax
from repro_torch.models import Backbone
from repro_torch.serve import (Batcher, CheckpointWatcher, Request, ServeEngine,
                               generator_from_state, make_buckets, plan_layout,
                               prefill_bucket, ring_index_map)
from repro_torch.serve import cache as tcache
from repro_torch.serve_generator import main as serve_main
from repro_torch.tree import tree_leaves, tree_map

JCFGS = {**JSERVE_CFGS, "hybrid": JMODEL_CFGS["hybrid"]}
PORTED = ["dense", "grouped_ring", "ssm", "audio", "hybrid"]
CFGS = {k: port_config(JCFGS[k]) for k in PORTED}


def _engine(key, **kw):
    return ServeEngine(CFGS[key], device="cpu", **kw)


def _frames(cfg, i):
    """Request i's (S_enc, d_model) float32 encoder frames (audio), else None."""
    if cfg.family != "audio":
        return None
    rng = np.random.default_rng(100 + i)
    return (0.1 * rng.standard_normal((cfg.encoder_seq, cfg.d_model))).astype(np.float32)


def _reference_greedy(cfg, params, prompt, gen, frames=None):
    """Batch-1 token-by-token greedy decode from scratch — exact for every
    family (threads SSM state one token at a time; an audio request's
    cross caches from its frames)."""
    bb = Backbone(cfg)
    T = len(prompt)
    cache = bb.init_cache(1, T + gen, device="cpu")
    if frames is not None:
        mem = bb.encode(params, torch.from_numpy(frames)[None])
        cache["cross"] = bb.build_cross_cache(params, mem)
    toks = list(prompt)
    outs = []
    for i in range(T + gen - 1):
        lg, cache = bb.decode(params, torch.tensor([[toks[i]]]), cache, i)
        if i >= T - 1:
            tok = int(lg[0, 0, :cfg.vocab_size].argmax())
            outs.append(tok)
            toks.append(tok)
    return outs


def _fedgan_style_state(params):
    """Wrap Backbone params as a (1, 1)-agent FedGAN train state."""
    return {"params": {"gen": tree_map(lambda x: x[None, None], params),
                       "disc": {"w": torch.zeros((1, 1, 3))}}}


def _init(cfg, seed=0):
    return Backbone(cfg).init(torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# bucketing, layouts and the ring index map against the reference
# ---------------------------------------------------------------------------


def test_serve_exports_the_reference_names():
    assert tserve.__all__ == jserve.__all__
    assert tcache.BATCH_AXIS == jcache.BATCH_AXIS and tcache.SEQ_AXIS == jcache.SEQ_AXIS
    assert tcache.EXACT_PREFILL_FAMILIES == jcache.EXACT_PREFILL_FAMILIES


@pytest.mark.parametrize("lo,hi", [(8, 64), (16, 100), (1, 1), (16, 4096), (3, 17)])
def test_bucket_policy_matches_reference(lo, hi):
    buckets = make_buckets(lo, hi)
    assert buckets == jserve.make_buckets(lo, hi)
    for key in PORTED:
        for n in range(1, hi + 1, max(hi // 37, 1)):
            assert prefill_bucket(CFGS[key], n, buckets) == \
                jserve.prefill_bucket(JCFGS[key], n, buckets)
            assert tcache.prefill_prefix(CFGS[key], n) == jcache.prefill_prefix(JCFGS[key], n)
    with pytest.raises(ValueError):
        prefill_bucket(CFGS["dense"], hi + 1, buckets)
    with pytest.raises(ValueError):
        make_buckets(hi + 1, hi)


def test_plan_layout_matches_reference():
    for key in PORTED:
        for max_seq in (2, 4, 64):
            for ring in (False, True):
                try:
                    want = jserve.plan_layout(JCFGS[key], max_seq, ring=ring)
                except ValueError:
                    with pytest.raises(ValueError):
                        plan_layout(CFGS[key], max_seq, ring=ring)
                    continue
                got = plan_layout(CFGS[key], max_seq, ring=ring)
                assert (got.kind, got.max_seq, got.window, got.ring) == \
                    (want.kind, want.max_seq, want.window, want.ring)


@pytest.mark.parametrize("window", [1, 4, 7])
@pytest.mark.parametrize("rel", ["below", "at", "above", "far_above"])
def test_ring_index_map_matches_reference(window, rel):
    T = {"below": max(window - 2, 1), "at": window, "above": window + 1,
         "far_above": 3 * window + 2}[rel]
    gather, pos = ring_index_map(T, window)
    jg, jp = jserve.ring_index_map(T, window)
    assert gather.dtype == torch.int64 and pos.dtype == torch.int32
    np.testing.assert_array_equal(gather.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
    # every live position sits in its own slot, once: slot s holds p = s mod W
    live = pos.numpy()[pos.numpy() >= 0]
    assert sorted(live.tolist()) == list(range(max(T - window, 0), T))
    assert all(p % window == s for s, p in enumerate(pos.numpy()) if p >= 0)


def test_batcher_admit_evict_invariants():
    b = Batcher(2)
    reqs = [Request(rid=-1, prompt=(1, 2), max_new_tokens=1) for _ in range(5)]
    rids = [b.submit(r) for r in reqs]
    assert rids == sorted(rids)  # monotone ids

    admitted = []
    while b.has_work:
        got = b.admit()
        admitted.extend(r.rid for _, r in got)
        # never over-subscribed; every occupied slot belongs to one request
        assert sum(r is not None for r in b.slots) <= b.max_slots
        occupied = [r.slot for r in b.slots if r is not None]
        assert len(set(occupied)) == len(occupied)
        for _, r in b.active():
            r.generated.append(0)  # finish everyone this tick
        evicted = b.evict()
        assert all(r.done and r.status == "done" for r in evicted)
    # FIFO, exactly once
    assert admitted == rids
    with pytest.raises(ValueError):
        Batcher(0)


# ---------------------------------------------------------------------------
# insert_slot: bit for bit the reference's, on the same numpy cache trees
# ---------------------------------------------------------------------------


def _kv(rng, lead, seq, dtype=np.float32):
    return {k: rng.standard_normal(lead + (seq, 2, 3)).astype(dtype) for k in ("k", "v")}


def _ring(rng, lead, W):
    node = _kv(rng, lead, W)
    node["pos"] = rng.integers(-1, 40, lead + (W,)).astype(np.int32)
    return node


def _case(name, rng):
    """(destination, request cache) numpy trees of one insert case; the
    batch cache has 3 slots and leading layer dims (2,) or (2, 1)."""
    B, S, W, Tb = 3, 12, 4, 8
    if name == "full":
        dst = {"local": _kv(rng, (2, 1, B), S), "global": _kv(rng, (2, B), S)}
        src = {"local": _kv(rng, (2, 1, 1), Tb), "global": _kv(rng, (2, 1), Tb)}
    elif name == "ring_from_full":
        dst = {"local": _ring(rng, (2, 1, B), W), "global": _kv(rng, (2, B), S)}
        src = {"local": _kv(rng, (2, 1, 1), Tb), "global": _kv(rng, (2, 1), Tb)}
    elif name == "ring_from_ring":
        dst = {"local": _ring(rng, (2, 1, B), W), "global": _kv(rng, (2, B), S)}
        src = {"local": _ring(rng, (2, 1, 1), W), "global": _kv(rng, (2, 1), Tb)}
        src["local"]["pos"][:] = -1
    elif name == "audio":    # self caches at the prompt's length, cross at the encoder's
        dst = {"self": _kv(rng, (2, B), S), "cross": _kv(rng, (2, B), 5)}
        src = {"self": _kv(rng, (2, 1), Tb), "cross": _kv(rng, (2, 1), 5)}
    elif name == "hybrid":   # the shared block's k/v per group, (groups, per) states, a tail
        dst = {"attn": _kv(rng, (2, B), S), "mamba": _ssm(rng, (2, 2, B)),
               "tail": _ssm(rng, (1, B))}
        src = {"attn": _kv(rng, (2, 1), Tb), "mamba": _ssm(rng, (2, 2, 1)),
               "tail": _ssm(rng, (1, 1))}
    else:  # ssm
        dst, src = {"blocks": _ssm(rng, (2, B))}, {"blocks": _ssm(rng, (2, 1))}
    return dst, src


def _ssm(rng, lead):
    return {"ssm": rng.standard_normal(lead + (2, 4, 5)).astype(np.float32),
            **{f"conv_{c}": rng.standard_normal(lead + (3, 6)).astype(np.float32)
               for c in "xbc"}}


@pytest.mark.parametrize("slot", [0, 2])
@pytest.mark.parametrize("case,prompt_len", [("full", 5), ("full", 8),
                                             ("ring_from_full", 2), ("ring_from_full", 4),
                                             ("ring_from_full", 7), ("ring_from_ring", 0),
                                             ("ssm", 0), ("audio", 6), ("hybrid", 8)])
def test_insert_slot_matches_reference_bit_for_bit(case, prompt_len, slot):
    dst, src = _case(case, np.random.default_rng(7))
    want = jax.device_get(jserve.insert_slot(tree_map(jnp.asarray, dst), tree_map(jnp.asarray, src),
                                             slot, prompt_len=prompt_len))
    tdst = tree_map(lambda x: torch.from_numpy(x.copy()), dst)
    got = tserve.insert_slot(tdst, tree_map(torch.from_numpy, src), slot, prompt_len=prompt_len)
    assert got is tdst                     # written in place
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert g.numpy().dtype == np.asarray(w).dtype and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


def test_insert_slot_casts_like_reference_and_refuses_overflow():
    """A float32 prefill row into a bfloat16 cache rounds as the
    reference's ``astype`` does; a prefill longer than the cache raises in
    both."""
    rng = np.random.default_rng(3)
    dst = {"k": np.zeros((2, 6, 2, 3), np.float32), "v": np.zeros((2, 6, 2, 3), np.float32)}
    src = _kv(rng, (1,), 5)
    want = jax.device_get(jserve.insert_slot(
        tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), dst), tree_map(jnp.asarray, src),
        1, prompt_len=5))
    got = tserve.insert_slot(tree_map(lambda x: torch.from_numpy(x).bfloat16(), dst),
                             tree_map(torch.from_numpy, src), 1, prompt_len=5)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key]).astype(np.float32))
    long = _kv(rng, (1,), 7)
    with pytest.raises(ValueError, match="capacity"):
        jserve.insert_slot(tree_map(jnp.asarray, dst), tree_map(jnp.asarray, long), 0,
                           prompt_len=7)
    with pytest.raises(ValueError, match="capacity"):
        tserve.insert_slot(tree_map(torch.from_numpy, dst), tree_map(torch.from_numpy, long), 0,
                           prompt_len=7)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", PORTED)
def test_engine_matches_reference_greedy(key):
    cfg = CFGS[key]
    eng = _engine(key, max_batch=2, max_seq=32, min_bucket=8, ring=key.endswith("_ring"))
    rids = [eng.submit(list(range(1, T + 1)), max_new_tokens=g, frames=_frames(cfg, i))
            for i, (T, g) in enumerate(WORK)]
    done = eng.run()
    assert set(done) == set(rids)
    for i, (rid, (T, g)) in enumerate(zip(rids, WORK)):
        want = _reference_greedy(cfg, eng.params, list(range(1, T + 1)), g, _frames(cfg, i))
        assert done[rid].generated == want, (key, rid)
    # three requests through two slots: the third was admitted mid-stream
    assert eng.stats.prefills == 3
    assert max(eng.stats.tick_active) == 2
    assert not eng.captured   # the CPU runs the tick eagerly


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("key", PORTED)
def test_engine_matches_reference_engine(key, temperature):
    """The reference's engine and the port's on the same params sample the
    same tokens: the same host Gumbel stream from ``rng_seed`` over logits
    that agree within float32 rounding."""
    ring = key.endswith("_ring")
    kw = dict(max_batch=2, max_seq=32, min_bucket=8, ring=ring, rng_seed=5)
    jeng = JServeEngine(JCFGS[key], **kw)
    teng = _engine(key, params=backbone_params_from_jax(jax.device_get(jeng.params),
                                                        device="cpu"), **kw)
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(list(range(2, T + 2)), max_new_tokens=g, temperature=temperature,
                           frames=_frames(CFGS[key], i))
                for i, (T, g) in enumerate(WORK)]
        done = eng.run()
        outs.append([done[r].generated for r in rids])
        assert eng.stats.prefills == 3 and max(eng.stats.tick_active) == 2
    assert outs[0] == outs[1]
    assert teng.stats.prefill_buckets == jeng.stats.prefill_buckets
    assert teng.stats.decode_ticks == jeng.stats.decode_ticks


def test_engine_stop_tokens_and_ticks_match_reference():
    """A request that samples a stop token ends early, in both engines."""
    kw = dict(max_batch=2, max_seq=32, min_bucket=8)
    jeng = JServeEngine(JCFGS["dense"], **kw)
    teng = _engine("dense", params=backbone_params_from_jax(jax.device_get(jeng.params),
                                                            device="cpu"), **kw)
    first = teng.submit([1, 2, 3], max_new_tokens=6)
    stop = teng.run()[first].generated[2]
    outs = []
    for eng in (jeng, teng):
        rid = eng.submit([1, 2, 3], max_new_tokens=6, stop_tokens=[stop])
        req = eng.run()[rid]
        outs.append((req.generated, req.stopped))
    assert outs[0] == outs[1] and outs[1][1] and outs[1][0][-1] == stop


def test_submit_validation_and_mesh():
    eng = _engine("dense", max_batch=1, max_seq=16, min_bucket=8)
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.submit(list(range(10)), max_new_tokens=10)  # 10+10 > 16
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeEngine(CFGS["dense"], mesh=object(), device="cpu")
    from repro_torch.launch.mesh import make_serving_mesh
    with pytest.raises(ValueError, match="cannot serve"):
        ServeEngine(CFGS["dense"], mesh=make_serving_mesh(device="cpu"), device="cuda")
    with pytest.raises(ValueError, match="sliding_window"):
        _engine("dense", ring=True)


def test_engine_on_serving_mesh_single_device():
    """The twin of the reference's test: the engine on the one-device
    serving mesh (DTensor params and cache, every spec replicated) gives
    the reference's greedy tokens."""
    from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
    from test_serve import _reference_greedy as jax_reference_greedy

    from repro_torch.dist.sharding import is_sharded
    from repro_torch.launch.mesh import make_serving_mesh
    jeng = JServeEngine(JCFGS["dense"], max_batch=2, max_seq=32, min_bucket=8,
                        mesh=jax_serving_mesh())
    jparams = jax.device_get(jeng.params)
    eng = _engine("dense", max_batch=2, max_seq=32, min_bucket=8,
                  params=backbone_params_from_jax(jparams, device="cpu"),
                  mesh=make_serving_mesh(device="cpu"))
    assert all(is_sharded(x) for x in tree_leaves(eng.params))
    assert all(is_sharded(x) for x in tree_leaves(eng.cache))
    rid = eng.submit([1, 2, 3, 4], max_new_tokens=3)
    want = jax_reference_greedy(JCFGS["dense"], jparams, [1, 2, 3, 4], 3)
    assert eng.run()[rid].generated == want


# ---------------------------------------------------------------------------
# hot reload
# ---------------------------------------------------------------------------


def test_generator_from_state_strips_agent_grid():
    params = _init(CFGS["dense"])
    got = generator_from_state(_fedgan_style_state(params))
    for a, b in zip(tree_leaves(got), tree_leaves(params)):
        assert torch.equal(a, b)


def test_hot_reload_picks_up_newer_checkpoint_mid_stream():
    cfg = CFGS["dense"]
    params0 = _init(cfg)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, _fedgan_style_state(params0), step=1)
        eng = _engine("dense", max_batch=1, max_seq=32, min_bucket=8, ckpt_dir=d)
        assert eng.loaded_step == 1
        ptrs = [x.data_ptr() for x in tree_leaves(eng.params) + tree_leaves(eng.cache)]
        rid = eng.submit([1, 2, 3, 4], max_new_tokens=8)
        for _ in range(3):
            eng.tick()
        # trainer finishes another round: zeroed generator is trivially
        # distinguishable from the step-1 weights
        save_checkpoint(d, _fedgan_style_state(tree_map(torch.zeros_like, params0)), step=2)
        done = {}
        while eng.batcher.has_work:
            for req in eng.tick():
                done[req.rid] = req
        assert eng.loaded_step == 2 and eng.stats.reloads == 1
        assert all(not x.any() for x in tree_leaves(eng.params))
        assert len(done[rid].generated) == 8  # request survived the swap
        # the weights were written into the served tensors, the cache kept
        assert ptrs == [x.data_ptr() for x in tree_leaves(eng.params) + tree_leaves(eng.cache)]


def test_hot_reload_leaves_callers_params_untouched():
    """With ``ckpt_dir`` set, the params given to the engine are copied:
    a reload writes the new weights into the engine's tensors, never into
    the caller's (a trainer's live generator, another engine's params)."""
    cfg = CFGS["dense"]
    mine = _init(cfg)
    kept = tree_map(torch.clone, mine)
    with tempfile.TemporaryDirectory() as d:
        eng = _engine("dense", max_batch=1, max_seq=32, min_bucket=8, ckpt_dir=d,
                      params=mine)
        assert eng.loaded_step is None
        save_checkpoint(d, _fedgan_style_state(tree_map(torch.zeros_like, mine)), step=1)
        rid = eng.submit([1, 2, 3, 4], max_new_tokens=4)
        assert len(eng.run()[rid].generated) == 4
        assert eng.loaded_step == 1 and eng.stats.reloads == 1
        assert all(not x.any() for x in tree_leaves(eng.params))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine), tree_leaves(kept)))


def test_reference_checkpoint_served_by_the_port():
    """A checkpoint the reference's trainer writes (``repro.checkpoint``)
    is what the port's watcher serves: its params are the reference's,
    converted, and the port's engine then samples the reference engine's
    tokens."""
    jcfg = JCFGS["grouped_ring"]
    jparams = JBackbone(jcfg).init(jax.random.key(3))
    with tempfile.TemporaryDirectory() as d:
        jsave_checkpoint(d, _jstate(jparams), step=4)
        kw = dict(max_batch=2, max_seq=32, min_bucket=8, ring=True)
        eng = _engine("grouped_ring", ckpt_dir=d, **kw)
        assert eng.loaded_step == 4
        want = backbone_params_from_jax(jax.device_get(jparams), device="cpu")
        for a, b in zip(tree_leaves(eng.params), tree_leaves(want)):
            assert torch.equal(a, b)
        jeng = JServeEngine(jcfg, ckpt_dir=d, **kw)
        outs = []
        for e in (jeng, eng):
            rids = [e.submit(list(range(1, T + 1)), max_new_tokens=g) for T, g in WORK]
            done = e.run()
            outs.append([done[r].generated for r in rids])
        assert outs[0] == outs[1]


def test_hot_reload_rejects_mismatched_arch():
    other = _init(port_config(JCFGS["dense"]).scaled(name="x", num_layers=3))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, _fedgan_style_state(other), step=1)
        eng = _engine("dense", max_batch=1, max_seq=16, min_bucket=8)
        eng.watcher = CheckpointWatcher(d, device="cpu")
        with pytest.raises(RuntimeError, match="does not match"):
            eng.maybe_reload()


def test_watcher_warns_once_on_wrong_layout_and_recovers():
    """A checkpoint the extractor cannot parse (raw Backbone params under
    the default FedGAN-state extractor) warns once, is not re-read every
    poll, and a later well-formed step still loads."""
    params = _init(CFGS["dense"])
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, step=1)  # raw params: no ["params"]["gen"]
        w = CheckpointWatcher(d, device="cpu")
        with pytest.warns(UserWarning, match="extract"):
            assert w.poll() is None
        assert w.poll() is None  # cached bad step: no second warning/IO
        save_checkpoint(d, _fedgan_style_state(params), step=2)
        got = w.poll()
        assert got is not None and got[1] == 2
        assert w.poll() is None  # nothing newer


def test_engine_waits_when_no_checkpoint_yet():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine("dense", max_batch=1, max_seq=16, min_bucket=8,
                      ckpt_dir=os.path.join(d, "empty"))
        assert eng.loaded_step is None  # falls back to init params, keeps polling
        assert not eng.maybe_reload()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--arch", "gemma3-4b", "--ring"],
                                  ["--arch", "mamba2-2.7b", "--temperature", "0"]])
def test_serve_generator_cli(argv, capsys):
    serve_main(argv + ["--device", "cpu", "--requests", "5", "--batch", "2",
                       "--prompt-len", "12", "--gen", "4"])
    out = capsys.readouterr().out
    assert "serve OK" in out and out.count("req ") == 5


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-medium", "chameleon-34b"])
def test_serve_generator_serves_the_new_families(arch, capsys):
    """``python -m repro_torch.serve_generator --arch ... --device cpu`` for
    the hybrid, audio (each request with its frames) and vlm archs at
    ``.smoke()``, greedy; an unknown arch is refused."""
    serve_main(["--arch", arch, "--device", "cpu", "--requests", "5", "--batch", "2",
                "--prompt-len", "12", "--gen", "4", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "serve OK" in out and out.count("req ") == 5 and f"arch={arch}" in out
    with pytest.raises(SystemExit):
        serve_main(["--arch", "no-such-arch", "--device", "cpu"])


def test_audio_request_without_frames_is_refused():
    """As the reference's engine: an audio request needs its frames."""
    eng = _engine("audio", max_batch=2, max_seq=32)
    with pytest.raises(ValueError, match="encoder frames"):
        eng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(ValueError, match="encoder frames"):
        JServeEngine(JCFGS["audio"], max_batch=2, max_seq=32).submit([1, 2, 3],
                                                                    max_new_tokens=2)
