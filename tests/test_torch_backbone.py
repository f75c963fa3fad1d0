"""The port's backbone on the CPU against the JAX reference: configs and
registry, the norms and embedding, the Backbone's logits through
``backbone_params_from_jax`` (the reference's own weights), and port
twins of the reference's behaviour tests (``tests/test_models.py``).

The JAX side runs as its own tests run it: ``Backbone(...,
use_flash=True)`` reaches the Pallas flash kernel in interpret mode,
``use_ssd_kernel=True`` the Pallas SSD kernel.  On the CPU the port's
kernel wrappers take their plain versions.

Tolerances, with their reasons: logits within 2e-4 in float32, as the
reference holds its flash and SSD routes to its plain model
(``tests/test_models.py``): both packages compute in float32 and differ in
summation order through every layer; decode against the full forward
within 5e-4 and the mask and causality checks within 1e-5, as in the
reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models import CFGS as JCFGS, _dense as _jdense
from torch_shared import one_torch_thread  # noqa: F401

from repro import nn as jnn
from repro.configs.registry import get_config as jget_config, list_archs as jlist_archs
from repro.models.transformer import Backbone as JBackbone

from repro_torch import nn as tnn
from repro_torch.configs.registry import get_config, get_shape, list_archs
from repro_torch.convert import backbone_params_from_jax
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.models import Backbone
from repro_torch.models.config import ArchConfig
from repro_torch.tree import tree_leaves, tree_map

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg) -> ArchConfig:
    """The port's ArchConfig with every field of a reference config."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["dtype"] = _DTYPES[fields["dtype"]]
    fields["param_dtype"] = _DTYPES[fields["param_dtype"]]
    return ArchConfig(**fields)


def _pair(jcfg, seed=0, **flags):
    """The same Backbone in both packages, on the reference's weights."""
    jb = JBackbone(jcfg, **flags)
    jp = jb.init(jax.random.key(seed))
    tb = Backbone(port_config(jcfg), **flags)
    return jb, jp, tb, backbone_params_from_jax(jax.device_get(jp), device="cpu")


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, registry, layers
# ---------------------------------------------------------------------------


PORTED_ARCHS = ["gemma3-4b", "mixtral-8x22b", "qwen3-8b", "phi4-mini-3.8b",
                "whisper-medium", "glm4-9b", "zamba2-7b", "granite-moe-3b-a800m",
                "chameleon-34b", "mamba2-2.7b"]


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_registry_configs_match_reference(arch):
    assert port_config(jget_config(arch)) == get_config(arch)
    assert port_config(jget_config(arch).smoke()) == get_config(arch).smoke()
    tcfg, jcfg = get_config(arch), jget_config(arch)
    for prop in ("padded_vocab", "resolved_head_dim", "d_inner", "resolved_ssm_heads",
                 "attention_free", "supports_long_decode"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop)
    assert [tcfg.is_global_layer(i) for i in range(tcfg.num_layers)] == \
        [jcfg.is_global_layer(i) for i in range(jcfg.num_layers)]


def test_registry_refuses_unported_archs():
    """Every arch of the reference is ported, in the reference's order; an
    arch neither package has is refused."""
    assert list_archs() == PORTED_ARCHS == jlist_archs()
    assert get_shape("prefill_32k").seq_len == 32_768
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_embedding_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    scale = (1.0 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    for jmod, tmod, p in [(jnn.RMSNorm(48), tnn.RMSNorm(48), {"scale": scale}),
                          (jnn.LayerNorm(48), tnn.LayerNorm(48), {"scale": scale, "bias": bias})]:
        got = tmod.apply({k: torch.from_numpy(v) for k, v in p.items()}, tx)
        want = jmod.apply({k: jnp.asarray(v) for k, v in p.items()}, jx)
        assert got.dtype == getattr(torch, dtype)
        tol = 1e-6 if dtype == "float32" else 2.0 ** -7   # bf16: one ulp of |y| <~ 4
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=tol * 4, rtol=tol)
    table = rng.standard_normal((11, 48)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 7))
    got = tnn.Embedding(11, 48).apply({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
    want = jnn.Embedding(11, 48).apply({"table": jnp.asarray(table)}, jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the Backbone against the reference
# ---------------------------------------------------------------------------

_LOGIT_CASES = {
    "gemma3-4b.smoke": (jget_config("gemma3-4b").smoke(), "use_flash"),
    "mamba2-2.7b.smoke": (jget_config("mamba2-2.7b").smoke(), "use_ssd_kernel"),
    "dense": (JCFGS["dense"], "use_flash"),
    "dense_window": (JCFGS["dense_window"], "use_flash"),
    "grouped": (JCFGS["grouped"], "use_flash"),
    "ssm": (JCFGS["ssm"], "use_ssd_kernel"),
}


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("key", list(_LOGIT_CASES))
def test_backbone_logits_match_jax(key, kernel):
    """Logits of ``apply`` on the reference's weights, with the kernel flag
    on (JAX: Pallas in interpret mode; port: the wrapper's plain version on
    the CPU) and off (both: the plain model)."""
    jcfg, flag = _LOGIT_CASES[key]
    jb, jp, tb, tp = _pair(jcfg, **{flag: kernel})
    T = 32
    toks = _tokens(jcfg.vocab_size, (2, T))
    before = (fkernel.flash_attention_bhsd.launches, skernel.ssd_bthd.launches)
    got = tb.apply(tp, torch.from_numpy(toks))
    assert (fkernel.flash_attention_bhsd.launches, skernel.ssd_bthd.launches) == before
    want = jb.apply(jp, jnp.asarray(toks))
    assert got["logits"].shape == (2, T, jcfg.padded_vocab)
    assert got["logits"].dtype == torch.float32
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-4)
    np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(want["hidden"]), atol=2e-4)


@pytest.mark.parametrize("key", ["gemma3-4b.smoke", "grouped"])
def test_prefill_cache_matches_jax(key):
    """``prefill``'s last-token logits and its padded KV caches, key by key,
    against the reference's, with the flash route on both sides."""
    jcfg, _ = _LOGIT_CASES[key]
    jb, jp, tb, tp = _pair(jcfg, use_flash=True)
    toks = _tokens(jcfg.vocab_size, (2, 24))
    got = tb.prefill(tp, torch.from_numpy(toks), max_seq=30)
    want = jax.device_get(jb.prefill(jp, jnp.asarray(toks), max_seq=30))
    assert got["logits"].shape == (2, 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-4)
    jleaves, jdef = jax.tree_util.tree_flatten_with_path(want["cache"])
    tcache = got["cache"]
    assert sorted(tcache) == sorted(want["cache"])
    for path, leaf in jleaves:
        t = tcache
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_allclose(t.numpy(), leaf, atol=2e-4)


# ---------------------------------------------------------------------------
# port twins of tests/test_models.py
# ---------------------------------------------------------------------------


def _port(key, **flags):
    cfg = port_config(JCFGS[key])
    bb = Backbone(cfg, **flags)
    return cfg, bb, bb.init(torch.Generator().manual_seed(0))


def _decode_all(bb, params, toks, cache, per_row):
    outs = []
    for i in range(toks.shape[1]):
        index = torch.full((toks.shape[0],), i) if per_row else i
        lg, cache = bb.decode(params, toks[:, i:i + 1], cache, index)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("key", ["dense", "dense_window", "grouped"])
def test_decode_matches_forward(key, per_row):
    cfg, bb, params = _port(key, use_flash=True)
    T, B = 12, 2
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, T)))
    full = bb.apply(params, toks)["logits"]
    assert full.shape == (B, T, cfg.padded_vocab)
    assert not torch.isnan(full).any()
    cache = bb.init_cache(B, T, device="cpu")
    dec = _decode_all(bb, params, toks, cache, per_row)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=5e-4)


def test_decode_rows_at_their_own_positions():
    """A per-row index decodes each row at its own position: row 0 one
    token ahead of row 1 gives row 0's next logits and row 1's current
    ones, as the full forward does."""
    cfg, bb, params = _port("grouped")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 10)))
    full = bb.apply(params, toks)["logits"]
    pre = bb.prefill(params, toks[:, :6], max_seq=10)
    cache = pre["cache"]
    lg, cache = bb.decode(params, toks[:, 6:7], cache, torch.tensor([6, 6]))
    step = torch.stack([toks[0, 7:8], toks[1, 6:7]])      # row 1 rewrites position 6
    lg, _ = bb.decode(params, step, cache, torch.tensor([7, 6]))
    np.testing.assert_allclose(lg[0, 0].numpy(), full[0, 7].numpy(), atol=5e-4)
    np.testing.assert_allclose(lg[1, 0].numpy(), full[1, 6].numpy(), atol=5e-4)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_then_decode_continues_correctly(use_flash):
    cfg, bb, params = _port("dense", use_flash=use_flash)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 12)))
    full = bb.apply(params, toks)["logits"]
    pre = bb.prefill(params, toks[:, :8], max_seq=12)
    np.testing.assert_allclose(pre["logits"][:, 0].numpy(), full[:, 7].numpy(), atol=5e-4)
    lg, _ = bb.decode(params, toks[:, 8:9], pre["cache"], 8)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 8].numpy(), atol=5e-4)


@pytest.mark.parametrize("use_flash", [False, True])
def test_sliding_window_actually_masks(use_flash):
    """A token far outside the window must not influence the output."""
    cfg = port_config(_jdense(name="wm", sliding_window=2, num_layers=1))
    bb = Backbone(cfg, use_flash=use_flash)
    params = bb.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 8)))
    out1 = bb.apply(params, toks)["logits"][:, -1]
    toks2 = toks.clone()
    toks2[:, 0] = (toks[:, 0] + 7) % cfg.vocab_size
    out2 = bb.apply(params, toks2)["logits"][:, -1]
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


@pytest.mark.parametrize("key,flag", [("dense", "use_flash"), ("grouped", "use_flash"),
                                      ("ssm", "use_ssd_kernel")])
def test_causality(key, flag):
    """Future tokens must not affect past logits."""
    cfg, bb, params = _port(key, **{flag: True})
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 12)))
    out1 = bb.apply(params, toks)["logits"][:, :5]
    toks2 = toks.clone()
    toks2[:, 7] = (toks[:, 7] + 3) % cfg.vocab_size
    out2 = bb.apply(params, toks2)["logits"][:, :5]
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# serving paths: ring caches, the SSM prefill state and decode
# ---------------------------------------------------------------------------

RING_CFGS = {"dense_window": JCFGS["dense_window"],
             "grouped_window": _jdense(name="gw", local_global_ratio=1, sliding_window=4,
                                       global_uses_window=True, num_layers=3),
             "grouped": JCFGS["grouped"]}


def _leaves_close(got, want, atol):
    """Port cache tree against the reference's (numpy), key by key; ``pos``
    leaves exactly."""
    jleaves, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(want))
    for path, leaf in jleaves:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype).endswith(str(leaf.dtype))
        if path[-1].key == "pos":
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            np.testing.assert_allclose(t.float().numpy(), np.asarray(leaf, np.float32),
                                       atol=atol)


def _rows(B, i, per_row):
    """Decode index of step i: scalar, or per-row positions offset by 3."""
    return (np.arange(B, dtype=np.int32) * 3 + i) if per_row else np.int32(i)


@pytest.mark.parametrize("per_row", [False, True])
def test_attention_decode_ring_matches_jax(per_row):
    """``Attention.init_cache(ring=True)`` and ``decode_ring`` against the
    reference's, step by step across three wraps of a width-4 ring."""
    from repro.models.layers import Attention as JAttention
    from repro_torch.models.layers import Attention
    jcfg = JCFGS["dense_window"]
    ja, ta = JAttention(jcfg), Attention(port_config(jcfg))
    jp = jax.device_get(ja.init(jax.random.key(2)))
    tp = backbone_params_from_jax(jp, device="cpu")
    B, W = 2, 4
    jc, tc = ja.init_cache(B, W, ring=True), ta.init_cache(B, W, ring=True, device="cpu")
    _leaves_close(tc, jc, 0)
    x = np.random.default_rng(4).standard_normal((14, B, 1, jcfg.d_model)).astype(np.float32)
    jdecode = jax.jit(ja.decode_ring)
    for i in range(14):
        idx = _rows(B, i, per_row)
        jy, jc = jdecode(jp, jnp.asarray(x[i]), jc, jnp.asarray(idx))
        ty, tc = ta.decode_ring(tp, torch.from_numpy(x[i]), tc, torch.as_tensor(idx))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    _leaves_close(tc, jc, 1e-5)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("key", list(RING_CFGS))
def test_ring_backbone_decode_matches_jax(key, per_row):
    """``Backbone(ring_cache=True)``: ``init_cache`` layouts (which layers
    go ring) and ``decode`` logits and caches against the reference's,
    across several wraps, with scalar and per-row indices."""
    jb, jp, tb, tp = _pair(RING_CFGS[key], ring_cache=True)
    B, steps = 2, 11
    jc, tc = jb.init_cache(B, 16), tb.init_cache(B, 16, device="cpu")
    _leaves_close(tc, jc, 0)
    toks = _tokens(RING_CFGS[key].vocab_size, (B, steps))
    jdecode = jax.jit(jb.decode)
    for i in range(steps):
        idx = _rows(B, i, per_row)
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(idx))
        tl, tc = tb.decode(tp, torch.from_numpy(toks[:, i:i + 1]), tc, torch.as_tensor(idx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    _leaves_close(tc, jc, 1e-5)


@pytest.mark.parametrize("ring", [False, True])
def test_vector_index_and_donated_decode_match_lockstep(ring):
    """``decode`` with a (B,) index of equal entries equals the scalar
    lockstep path bit for bit, in the full and the ring layout; so does the
    donated decode (written in place, the cache returned), in both forms."""
    cfg = port_config(_jdense(sliding_window=4))
    bb = Backbone(cfg, ring_cache=ring)
    params = bb.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 9)))
    cache = bb.init_cache(2, 12, device="cpu")
    for i in range(8):
        _, cache = bb.decode(params, toks[:, i:i + 1], cache, i)
    before = tree_map(torch.clone, cache)
    ref_lg, ref_cache = bb.decode(params, toks[:, 8:], cache, 8)
    for index in (8, torch.full((2,), 8)):
        for donate in (False, True):
            mine = tree_map(torch.clone, cache)
            lg, new = bb.decode(params, toks[:, 8:], mine, index, donate=donate)
            assert (new is mine) == donate
            assert torch.equal(lg, ref_lg)
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                         tree_leaves(ref_cache)))
    # the functional calls left the cache they were given as it was
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), tree_leaves(before)))


def _ssm_pair(seed=0):
    from repro.models.ssm import Mamba2Block as JMamba
    from repro_torch.models.ssm import Mamba2Block
    jcfg = JCFGS["ssm"]
    jm, tm = JMamba(jcfg), Mamba2Block(port_config(jcfg))
    jp = jax.device_get(jm.init(jax.random.key(seed)))
    return jcfg, jm, jp, tm, backbone_params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("T", [2, 3, 8, 12])
def test_mamba_block_state_and_decode_match_jax(T):
    """``Mamba2Block.apply(return_state=True)`` (the chunked scan's final
    state and the conv tails, zero-padded on the left when T < k - 1),
    ``init_cache`` and ``decode`` against the reference's."""
    jcfg, jm, jp, tm, tp = _ssm_pair()
    u = np.random.default_rng(5).standard_normal((2, T + 3, jcfg.d_model)).astype(np.float32)
    jy, jst = jax.jit(lambda p, x: jm.apply(p, x, return_state=True))(jp, jnp.asarray(u[:, :T]))
    ty, tst = tm.apply(tp, torch.from_numpy(u[:, :T]), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    _leaves_close(tst, jst, 1e-5)
    _leaves_close(tm.init_cache(2), jm.init_cache(2), 0)
    jdecode = jax.jit(jm.decode)
    for i in range(T, T + 3):
        jy, jst = jdecode(jp, jnp.asarray(u[:, i:i + 1]), jst)
        ty, tst = tm.decode(tp, torch.from_numpy(u[:, i:i + 1]), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    _leaves_close(tst, jst, 1e-5)


@pytest.mark.parametrize("T", [3, 8])
def test_ssm_backbone_prefill_and_decode_match_jax(T):
    """The SSM ``Backbone``: ``prefill`` (logits and cache), ``init_cache``
    and ``decode`` against the reference's."""
    jb, jp, tb, tp = _pair(JCFGS["ssm"])
    toks = _tokens(JCFGS["ssm"].vocab_size, (2, T + 4))
    jo = jb.prefill(jp, jnp.asarray(toks[:, :T]), max_seq=T + 4)
    to = tb.prefill(tp, torch.from_numpy(toks[:, :T]), max_seq=T + 4)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=1e-5)
    _leaves_close(to["cache"], jo["cache"], 1e-5)
    _leaves_close(tb.init_cache(2, 6, device="cpu"), jb.init_cache(2, 6), 0)
    jc, tc = jo["cache"], to["cache"]
    jdecode = jax.jit(jb.decode)
    for i in range(T, T + 4):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.int32(i))
        tl, tc = tb.decode(tp, torch.from_numpy(toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    _leaves_close(tc, jc, 1e-5)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_ssm_prefill_state_then_decode_equals_decode_from_scratch(T):
    """The prefill's state (scan state and conv tails) followed by decode
    gives the logits of decoding every token from a zeroed cache."""
    cfg, bb, params = _port("ssm")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, T + 4)))
    pre = bb.prefill(params, toks[:, :T])
    cache = bb.init_cache(2, T + 4, device="cpu")
    for i in range(T + 4):
        lg, cache = bb.decode(params, toks[:, i:i + 1], cache, i)
        if i == T - 1:
            np.testing.assert_allclose(pre["logits"].numpy(), lg.numpy(), atol=1e-5)
            mine = pre["cache"]
        if i >= T:
            lg2, mine = bb.decode(params, toks[:, i:i + 1], mine, i)
            np.testing.assert_allclose(lg2.numpy(), lg.numpy(), atol=1e-5)


@pytest.mark.parametrize("T", [4, 8, 12])
def test_ssd_kernel_prefill_matches_plain(T):
    """The decode-cache prefill with the SSD kernel flag set goes through
    the kernel's wrapper, which returns the scan's final state; on the CPU
    the wrapper takes the plain ``ssd_ref``, so the prefill (logits and
    every cache leaf) equals the flag-free one exactly, and no kernel is
    launched.  Then decode continues from it as from the plain cache."""
    cfg, bb, params = _port("ssm", use_ssd_kernel=True)
    plain = Backbone(cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, T + 2)))
    before = skernel.ssd_bthd.launches
    got = bb.prefill(params, toks[:, :T], max_seq=T + 2)
    assert skernel.ssd_bthd.launches == before
    want = plain.prefill(params, toks[:, :T], max_seq=T + 2)
    assert torch.equal(got["logits"], want["logits"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["cache"]),
                                                 tree_leaves(want["cache"])))
    lg, _ = bb.decode(params, toks[:, T:T + 1], got["cache"], T)
    lw, _ = plain.decode(params, toks[:, T:T + 1], want["cache"], T)
    assert torch.equal(lg, lw)
