"""The port's hybrid (zamba2), audio (whisper) and vlm (chameleon)
backbone families on the CPU against the JAX reference.

Both packages get the same numpy inputs (tokens and, for the audio
family, encoder frames) and the reference's weights through
``backbone_params_from_jax``.  The configs are ``tests/test_models.py``'s
``hybrid`` and ``audio``, a hybrid with a Mamba2 tail after two groups
(the shared block applied twice), and each new arch's ``.smoke()``.  The
JAX side runs as its own tests run it (``use_flash`` through the Pallas
flash kernel in interpret mode, ``use_ssd_kernel`` through the Pallas SSD
scan); on the CPU the port's wrappers take their plain versions.

Tolerances, as the backbone parity tests of ``test_torch_backbone.py``
take them: logits, hidden states, encoder memory and caches within 2e-4
in float32 (both packages sum in another order through every layer);
decode against the full forward within 5e-4, as in the reference's
``test_decode_matches_forward``; the one-step decode against the
reference's within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models import CFGS as JCFGS
from test_torch_backbone import _leaves_close, port_config
from torch_shared import one_torch_thread  # noqa: F401

from repro.configs.registry import get_config as jget_config, list_archs as jlist_archs
from repro.configs.registry import pair_supported as jpair_supported
from repro.models.config import SHAPES as JSHAPES
from repro.models.transformer import Backbone as JBackbone

from repro_torch.configs.registry import get_config, list_archs, pair_supported
from repro_torch.convert import backbone_params_from_jax
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.models import Backbone
from repro_torch.tree import tree_leaves

CASES = {
    "hybrid": JCFGS["hybrid"],
    "hybrid_tail": JCFGS["hybrid"].scaled(name="ht", num_layers=7),
    "audio": JCFGS["audio"],
    "zamba2-7b.smoke": jget_config("zamba2-7b").smoke(),
    "whisper-medium.smoke": jget_config("whisper-medium").smoke(),
    "chameleon-34b.smoke": jget_config("chameleon-34b").smoke(),
}
FLAGS = {"hybrid": ("use_flash", "use_ssd_kernel"), "audio": ("use_flash",),
         "vlm": ("use_flash",)}


def _flags(jcfg, on):
    return {f: on for f in FLAGS[jcfg.family]}


def _pair(jcfg, seed=0, **flags):
    jb = JBackbone(jcfg, **flags)
    jp = jb.init(jax.random.key(seed))
    tb = Backbone(port_config(jcfg), **flags)
    return jb, jp, tb, backbone_params_from_jax(jax.device_get(jp), device="cpu")


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _frames(jcfg, B, seed=2):
    """(B, S_enc, d_model) float32 encoder frames for an audio config, else None."""
    if jcfg.family != "audio":
        return None
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model))).astype(np.float32)


def _kw(frames, lib):
    """``encoder_frames=`` for the audio family, in ``lib``'s arrays."""
    if frames is None:
        return {}
    return {"encoder_frames": jnp.asarray(frames) if lib == "jax" else torch.from_numpy(frames)}


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


def test_registry_has_all_ten():
    """The port twin of ``test_registry_has_all_ten``: every family."""
    archs = list_archs()
    assert archs == jlist_archs() and len(archs) == 10
    assert {get_config(a).family for a in archs} == \
        {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}


@pytest.mark.parametrize("arch", jlist_archs())
def test_full_config_matches_assignment(arch):
    """The port twin of the reference's test of the same name: every full
    config the reference's, field for field, with its provenance."""
    cfg = get_config(arch)
    assert cfg == port_config(jget_config(arch)) and cfg.source


def test_long_decode_support_flags():
    """``pair_supported`` and ``supports_long_decode`` as the reference's,
    for every arch and shape (the twin of the reference's test)."""
    runs = {a: pair_supported(a, "long_500k")[0] for a in list_archs()}
    assert runs == {
        "gemma3-4b": True, "mixtral-8x22b": True, "qwen3-8b": False,
        "phi4-mini-3.8b": False, "whisper-medium": False, "glm4-9b": False,
        "zamba2-7b": True, "granite-moe-3b-a800m": False,
        "chameleon-34b": False, "mamba2-2.7b": True,
    }
    for a in list_archs():
        assert get_config(a).supports_long_decode == jget_config(a).supports_long_decode
        assert get_config(a).attention_free == (a == "mamba2-2.7b")
        for shape in JSHAPES:
            assert pair_supported(a, shape) == jpair_supported(a, shape)


def test_hybrid_structure_matches_reference():
    """zamba2-7b's grouping (81 blocks: 13 groups of the shared block and 5
    Mamba2 layers, then 3 Mamba2) and, at each case, the params tree:
    the reference's keys and shapes, one shared block."""
    bb = Backbone(get_config("zamba2-7b"))
    jb = JBackbone(jget_config("zamba2-7b"))
    assert (bb.n_groups, bb.n_tail) == (jb.n_groups, jb.n_tail) == (13, 3)
    for key, jcfg in CASES.items():
        jp = jax.device_get(JBackbone(jcfg).init(jax.random.key(0)))
        tp = Backbone(port_config(jcfg)).init(torch.Generator().manual_seed(0))
        jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(jleaves) == len(tree_leaves(tp)), key
        for path, leaf in jleaves:
            t = tp
            for k in path:
                t = t[k.key]
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, (key, path)


# ---------------------------------------------------------------------------
# apply, prefill and encode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("key", list(CASES))
def test_family_logits_match_jax(key, kernel):
    """``apply``'s logits and hidden states on the reference's weights,
    with the family's kernel flags on (JAX: Pallas in interpret mode; the
    port: the wrappers' plain versions on the CPU, no launch) and off."""
    jcfg = CASES[key]
    jb, jp, tb, tp = _pair(jcfg, **_flags(jcfg, kernel))
    T = 16
    toks = _tokens(jcfg.vocab_size, (2, T))
    frames = _frames(jcfg, 2)
    before = (fkernel.flash_attention_bhsd.launches, skernel.ssd_bthd.launches)
    got = tb.apply(tp, torch.from_numpy(toks), **_kw(frames, "torch"))
    assert (fkernel.flash_attention_bhsd.launches, skernel.ssd_bthd.launches) == before
    want = jb.apply(jp, jnp.asarray(toks), **_kw(frames, "jax"))
    assert got["logits"].shape == (2, T, jcfg.padded_vocab)
    _close(got["logits"], want["logits"], 2e-4)
    _close(got["hidden"], want["hidden"], 2e-4)


@pytest.mark.parametrize("key", list(CASES))
def test_family_prefill_then_decode_match_jax(key):
    """``prefill`` (last-token logits, every cache leaf key by key, the
    audio family's ``memory``) with the kernel flags on both sides, then
    decode steps from that cache with a per-row index: logits and the
    caches against the reference's."""
    jcfg = CASES[key]
    jb, jp, tb, tp = _pair(jcfg, **_flags(jcfg, True))
    T, steps = 8, 3
    toks = _tokens(jcfg.vocab_size, (2, T + steps))
    frames = _frames(jcfg, 2)
    got = tb.prefill(tp, torch.from_numpy(toks[:, :T]), max_seq=T + steps,
                     **_kw(frames, "torch"))
    want = jax.device_get(jb.prefill(jp, jnp.asarray(toks[:, :T]), max_seq=T + steps,
                                     **_kw(frames, "jax")))
    _close(got["logits"], want["logits"], 2e-4)
    assert sorted(got["cache"]) == sorted(want["cache"])
    _leaves_close(got["cache"], want["cache"], 2e-4)
    if frames is not None:
        _close(got["memory"], want["memory"], 2e-4)
    jc, tc = want["cache"], got["cache"]
    jdecode = jax.jit(jb.decode)
    for i in range(T, T + steps):
        idx = np.full((2,), i, np.int32)
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(idx))
        tl, tc = tb.decode(tp, torch.from_numpy(toks[:, i:i + 1]), tc, torch.from_numpy(idx))
        _close(tl, jl, 2e-4)
    _leaves_close(tc, jc, 2e-4)


@pytest.mark.parametrize("key", ["audio", "whisper-medium.smoke"])
def test_encode_and_cross_cache_match_jax(key):
    """``encode`` (the non-causal encoder, through flash on both sides) and
    ``build_cross_cache`` against the reference's; then, as the reference's
    ``test_smoke_decode_step``, one decode step from a zeroed cache holding
    that cross cache; and the refusals of a family without one."""
    jcfg = CASES[key]
    jb, jp, tb, tp = _pair(jcfg, use_flash=True)
    frames = _frames(jcfg, 2)
    tmem = tb.encode(tp, torch.from_numpy(frames))
    jmem = jb.encode(jp, jnp.asarray(frames))
    assert tmem.shape == (2, jcfg.encoder_seq, jcfg.d_model)
    _close(tmem, jmem, 2e-4)
    tcross, jcross = tb.build_cross_cache(tp, tmem), jb.build_cross_cache(jp, jmem)
    assert tuple(tcross["k"].shape) == (jcfg.num_layers, 2, jcfg.encoder_seq,
                                        jcfg.num_kv_heads, jcfg.resolved_head_dim)
    _leaves_close(tcross, jcross, 2e-4)
    tc, jc = tb.init_cache(2, 16, device="cpu"), jb.init_cache(2, 16)
    _leaves_close(tc, jc, 0)
    tc["cross"], jc["cross"] = tcross, jcross
    tok = _tokens(jcfg.vocab_size, (2, 1))
    tl, tc = tb.decode(tp, torch.from_numpy(tok), tc, 0)
    jl, jc = jb.decode(jp, jnp.asarray(tok), jc, jnp.int32(0))
    assert tl.shape == (2, 1, jcfg.padded_vocab) and not torch.isnan(tl).any()
    _close(tl, jl, 1e-5)
    _leaves_close(tc, jax.device_get(jc), 1e-5)
    with pytest.raises(ValueError, match="only the audio"):
        Backbone(port_config(CASES["hybrid"])).build_cross_cache(tp, tmem)
    with pytest.raises(ValueError, match="encoder_frames"):
        tb.apply(tp, torch.from_numpy(tok))


def test_cross_attention_matches_jax():
    """``Attention`` over an encoder memory: the full-sequence ``apply``,
    ``decode(memory=)`` and ``decode_memory`` on ``build_memory_cache``
    against the reference's (queries without RoPE or a mask); the decode
    returns the cache it was given."""
    from repro.models.layers import Attention as JAttention
    from repro_torch.models.layers import Attention
    jcfg = CASES["audio"]
    ja, ta = JAttention(jcfg, causal=False), Attention(port_config(jcfg), causal=False)
    jp = jax.device_get(ja.init(jax.random.key(4)))
    tp = backbone_params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(9)
    x, mem = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 64), (2, 8, 64)))
    _close(ta.apply(tp, torch.from_numpy(x), memory=torch.from_numpy(mem)),
           ja.apply(jp, jnp.asarray(x), memory=jnp.asarray(mem)), 1e-5)
    cache = {"k": torch.zeros(1)}
    ty, tc = ta.decode(tp, torch.from_numpy(x[:, :1]), cache, 0, memory=torch.from_numpy(mem))
    jy, _ = ja.decode(jp, jnp.asarray(x[:, :1]), {}, 0, memory=jnp.asarray(mem))
    assert tc is cache
    _close(ty, jy, 1e-5)
    tm = ta.decode_memory(tp, torch.from_numpy(x[:, :1]),
                          ta.build_memory_cache(tp, torch.from_numpy(mem)))
    assert torch.equal(tm, ty)


@pytest.mark.parametrize("key", ["zamba2-7b.smoke", "whisper-medium.smoke"])
def test_smoke_decode_step(key):
    """The twin of the reference's ``test_smoke_decode_step``: one decode
    step of the ``.smoke()`` config from a zeroed cache against the
    reference's, the logits and the new cache."""
    jcfg = CASES[key]
    jb, jp, tb, tp = _pair(jcfg)
    tc, jc = tb.init_cache(2, 16, device="cpu"), jb.init_cache(2, 16)
    _leaves_close(tc, jc, 0)
    frames = _frames(jcfg, 2)
    if frames is not None:
        tc["cross"] = tb.build_cross_cache(tp, tb.encode(tp, torch.from_numpy(frames)))
        jc["cross"] = jb.build_cross_cache(jp, jb.encode(jp, jnp.asarray(frames)))
    tok = _tokens(jcfg.vocab_size, (2, 1))
    tl, tc = tb.decode(tp, torch.from_numpy(tok), tc, 0)
    jl, jc = jb.decode(jp, jnp.asarray(tok), jc, jnp.int32(0))
    _close(tl, jl, 1e-5)
    _leaves_close(tc, jax.device_get(jc), 1e-5)


# ---------------------------------------------------------------------------
# port twins of tests/test_models.py
# ---------------------------------------------------------------------------


def _decode_all(bb, params, toks, cache, frames, per_row):
    if frames is not None:
        cache["cross"] = bb.build_cross_cache(params, bb.encode(params, frames))
    outs = []
    for i in range(toks.shape[1]):
        index = torch.full((toks.shape[0],), i) if per_row else i
        lg, cache = bb.decode(params, toks[:, i:i + 1], cache, index)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("key", list(CASES))
def test_decode_matches_forward(key, per_row):
    """The twin of the reference's test: token-by-token decode from a
    zeroed cache reproduces the full forward's logits (the forward through
    the kernel flags)."""
    jcfg = CASES[key]
    cfg = port_config(jcfg)
    bb = Backbone(cfg, **_flags(jcfg, True))
    params = bb.init(torch.Generator().manual_seed(0))
    T, B = 16, 2
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, T)))
    frames = _frames(jcfg, B)
    frames = None if frames is None else torch.from_numpy(frames)
    full = bb.apply(params, toks, **({} if frames is None else {"encoder_frames": frames}))
    assert full["logits"].shape == (B, T, cfg.padded_vocab)
    assert not torch.isnan(full["logits"]).any()
    dec = _decode_all(bb, params, toks, bb.init_cache(B, T, device="cpu"), frames, per_row)
    np.testing.assert_allclose(dec.numpy(), full["logits"].numpy(), atol=5e-4)


@pytest.mark.parametrize("key", ["hybrid_tail", "audio"])
def test_donated_decode_equals_functional(key):
    """``decode(donate=True)`` writes every layer's cache in place (the
    shared block's k/v at each group, the Mamba2 states, the audio self
    caches; the cross caches read as given) and returns it, bit for bit
    the functional decode, which leaves the cache it was given as it was."""
    jcfg = CASES[key]
    cfg = port_config(jcfg)
    bb = Backbone(cfg)
    params = bb.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 6)))
    frames = _frames(jcfg, 2)
    cache = bb.init_cache(2, 8, device="cpu")
    if frames is not None:
        cache["cross"] = bb.build_cross_cache(params, bb.encode(params, torch.from_numpy(frames)))
    for i in range(5):
        _, cache = bb.decode(params, toks[:, i:i + 1], cache, i)
    before = [x.clone() for x in tree_leaves(cache)]
    lg, new = bb.decode(params, toks[:, 5:], cache, torch.full((2,), 5))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), before))
    mine = Backbone(cfg).init_cache(2, 8, device="cpu")
    for dst, src in zip(tree_leaves(mine), before):
        dst.copy_(src)
    lg2, new2 = bb.decode(params, toks[:, 5:], mine, torch.full((2,), 5), donate=True)
    assert new2 is mine and torch.equal(lg, lg2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new2), tree_leaves(new)))


@pytest.mark.parametrize("key", ["hybrid_tail", "chameleon-34b.smoke"])
def test_causality(key):
    """Future tokens must not affect past logits, through the kernel flags."""
    jcfg = CASES[key]
    cfg = port_config(jcfg)
    bb = Backbone(cfg, **_flags(jcfg, True))
    params = bb.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 16)))
    out1 = bb.apply(params, toks)["logits"][:, :5]
    toks2 = toks.clone()
    toks2[:, 9] = (toks[:, 9] + 3) % cfg.vocab_size
    out2 = bb.apply(params, toks2)["logits"][:, :5]
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


def test_encoder_is_not_causal():
    """The audio encoder attends both ways: changing the last frame moves
    the first position's memory (and a decoder token's logits), where a
    causal mask would leave them."""
    jcfg = CASES["audio"]
    cfg = port_config(jcfg)
    bb = Backbone(cfg, use_flash=True)
    params = bb.init(torch.Generator().manual_seed(0))
    frames = torch.from_numpy(_frames(jcfg, 1))
    moved = frames.clone()
    moved[:, -1] = -frames[:, -1]
    m1, m2 = bb.encode(params, frames), bb.encode(params, moved)
    assert float((m1[:, 0] - m2[:, 0]).abs().max()) > 1e-3
