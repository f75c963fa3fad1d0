"""The port's MoE FFN and MoE Backbone on the CPU against the JAX
reference (``repro.models.moe``), on the reference's own weights through
``backbone_params_from_jax``.

The routing is compared first and exactly: the expert choices
(``gate_idx``), each choice's slot in its expert's buffer (``pos``) and the
capacity drop (``keep``), token by token.  The reference's routing is
recomputed here with its own operations (``_jax_route`` repeats the lines
of ``MoE.apply`` up to the drop).  Any routing disagreement is counted and
must be 0 at these shapes: a flip at a near-tie between the k-th and the
(k+1)-th expert would move a token's output by O(1), and is not hidden
by a tolerance.

Tolerances, with their reasons: the MoE's output and aux loss within 1e-5
of the largest magnitude (float32 both sides, summation order differs in
the einsums); gradients under ``vmap`` within 1e-5 of each leaf's largest;
the Backbone's logits within 2e-4 as the dense family's
(``tests/test_torch_backbone.py``); decode against the full forward within
5e-2 for MoE as the reference's own test holds it (capacity drops differ
between a T-token group and a 1-token one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models import CFGS as JCFGS
from test_torch_backbone import _pair, _tokens, port_config
from torch_shared import one_torch_thread  # noqa: F401

from repro.configs.registry import get_config as jget_config
from repro.models.moe import MoE as JMoE

from repro_torch.convert import backbone_params_from_jax
from repro_torch.models import Backbone
from repro_torch.models.moe import MoE
from repro_torch.tree import tree_leaves

MOE_CFGS = {
    "moe": JCFGS["moe"],                                       # E 4, k 2, G 4, cf 2
    "granite.smoke": jget_config("granite-moe-3b-a800m").smoke(),   # E 4, k 2, G 16
    "mixtral.smoke": jget_config("mixtral-8x22b").smoke(),
    "drop": dataclasses.replace(JCFGS["moe"], name="drop", capacity_factor=0.5,
                                moe_group_size=8),
}


def _jax_route(jcfg, params, x):
    """The reference's routing, its own operations (``MoE.apply`` up to the
    capacity drop): (gate_idx, pos, keep) as numpy."""
    E, k = jcfg.num_experts, jcfg.experts_per_token
    B, T, d = x.shape
    G = max(min(jcfg.moe_group_size, T), 1)
    xt = x.reshape((B * T) // G, G, d)
    logits = (xt @ params["router"]["w"].astype(jcfg.dtype)).astype(jnp.float32)
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    flat = onehot.reshape(xt.shape[0], G * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    pos = pos.reshape(xt.shape[0], G, k).astype(jnp.int32)
    cap = int(max(1, (k * G * jcfg.capacity_factor) // E))
    return np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < cap)


def _moe_pair(jcfg, seed=0, zero_router=False):
    jm = JMoE(jcfg)
    jp = jax.device_get(jm.init(jax.random.key(seed)))
    if zero_router:
        jp["router"]["w"] = np.zeros_like(jp["router"]["w"])
    return jm, jp, MoE(port_config(jcfg)), backbone_params_from_jax(jp, device="cpu")


def _routing_mismatches(tm, tp, jcfg, jp, x):
    """Tokens whose (gate_idx, pos, keep) differ between the packages."""
    _, _, idx, pos, keep = tm.route(tp, torch.from_numpy(x))
    jidx, jpos, jkeep = _jax_route(jcfg, jp, jnp.asarray(x))
    bad = ((idx.numpy() != jidx) | (pos.numpy() != jpos) | (keep.numpy() != jkeep)).any(-1)
    return int(bad.sum()), keep.numpy()


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("key", list(MOE_CFGS))
def test_moe_apply_matches_jax(key):
    """Routing equal on every token; y and aux within 1e-5."""
    jcfg = MOE_CFGS[key]
    jm, jp, tm, tp = _moe_pair(jcfg)
    x = np.random.default_rng(3).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    bad, keep = _routing_mismatches(tm, tp, jcfg, jp, x)
    assert bad == 0, f"{bad} tokens routed differently"
    if key == "drop":
        assert not keep.all()      # the case exists to drop choices
    ty, taux = tm.apply(tp, torch.from_numpy(x))
    jy, jaux = jax.jit(jm.apply)(jp, jnp.asarray(x))
    assert ty.shape == x.shape and taux.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(taux.item(), jaux)


def test_moe_zero_router_ties_break_to_the_lower_expert():
    """With a zero router every probability ties: the reference's
    ``top_k`` takes experts 0..k-1, in order, for every token; so must the
    port, with the same slots and drops."""
    jcfg = MOE_CFGS["drop"]
    jm, jp, tm, tp = _moe_pair(jcfg, zero_router=True)
    x = np.random.default_rng(4).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    _, gate_vals, idx, _, keep = tm.route(tp, torch.from_numpy(x))
    k = jcfg.experts_per_token
    assert (idx.numpy() == np.arange(k)).all()
    np.testing.assert_array_equal(gate_vals.numpy(), np.full(idx.shape, 1.0 / k, np.float32))
    bad, _ = _routing_mismatches(tm, tp, jcfg, jp, x)
    assert bad == 0 and not keep.all()
    ty, taux = tm.apply(tp, torch.from_numpy(x))
    jy, jaux = jax.jit(jm.apply)(jp, jnp.asarray(x))
    _close(ty.numpy(), jy)
    _close(taux.item(), jaux)


def test_moe_capacity_order_is_token_major():
    """Slots are handed out over the group's tokens in order, then over a
    token's choices: with a zero router the j-th token's choice c sits at
    slot j of expert c, and every token past the capacity is dropped."""
    jcfg = MOE_CFGS["drop"]
    _, _, tm, tp = _moe_pair(jcfg, zero_router=True)
    G = jcfg.moe_group_size
    x = torch.randn((1, G, jcfg.d_model), generator=torch.Generator().manual_seed(0))
    _, _, _, pos, keep = tm.route(tp, x)
    cap = tm.capacity(G)
    assert cap < G
    np.testing.assert_array_equal(
        pos[0].numpy(), np.repeat(np.arange(G)[:, None], jcfg.experts_per_token, 1))
    assert (keep[0].numpy() == (np.arange(G) < cap)[:, None]).all()


@pytest.mark.parametrize("key", ["moe", "granite.smoke", "drop"])
def test_moe_vmap_grad_matches_jax(key):
    """The gradient of sum(y·r) + aux wrt every parameter, per agent under
    ``torch.func.vmap`` (the local step's form) against ``jax.vmap(jax.grad)``
    over two agents' params and inputs."""
    jcfg = MOE_CFGS[key]
    jm = JMoE(jcfg)
    jps = jax.device_get(jax.vmap(jm.init)(jax.random.split(jax.random.key(1), 2)))
    tm, tps = MoE(port_config(jcfg)), backbone_params_from_jax(jps, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 16, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx, rr):
        y, aux = jm.apply(p, xx)
        return jnp.sum(y * rr) + aux

    def tloss(p, xx, rr):
        y, aux = tm.apply(p, xx)
        return torch.sum(y * rr) + aux

    jg = jax.jit(jax.vmap(jax.grad(jloss)))(jps, jnp.asarray(x), jnp.asarray(r))
    tg = torch.func.vmap(torch.func.grad(tloss))(tps, torch.from_numpy(x), torch.from_numpy(r))
    jl, tl = jax.tree_util.tree_leaves(jax.device_get(jg)), tree_leaves(tg)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        _close(t.numpy(), j)


@pytest.mark.parametrize("key", ["moe", "granite.smoke", "mixtral.smoke"])
def test_moe_backbone_logits_and_aux_match_jax(key):
    """The MoE Backbone's logits, hidden states and aux (summed over the
    layers) on the reference's weights."""
    jcfg = MOE_CFGS[key]
    jb, jp, tb, tp = _pair(jcfg)
    toks = _tokens(jcfg.vocab_size, (2, 32))
    got = tb.apply(tp, torch.from_numpy(toks))
    want = jax.jit(jb.apply)(jp, jnp.asarray(toks))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-4)
    np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(want["hidden"]), atol=2e-4)
    assert got["aux"].dtype == torch.float32 and got["aux"].dim() == 0
    _close(got["aux"].item(), want["aux"])


def test_moe_prefill_and_decode_match_jax():
    """``prefill`` (last-token logits, caches) then ``decode`` steps of the
    MoE Backbone against the reference's, step by step."""
    jcfg = MOE_CFGS["granite.smoke"]
    jb, jp, tb, tp = _pair(jcfg)
    toks = _tokens(jcfg.vocab_size, (2, 20))
    jo = jb.prefill(jp, jnp.asarray(toks[:, :16]), max_seq=20)
    to = tb.prefill(tp, torch.from_numpy(toks[:, :16]), max_seq=20)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), atol=2e-4)
    jc, tc = jo["cache"], to["cache"]
    jdecode = jax.jit(jb.decode)
    for i in range(16, 20):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.int32(i))
        tl, tc = tb.decode(tp, torch.from_numpy(toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)


# ---------------------------------------------------------------------------
# port twins of tests/test_models.py for the moe config
# ---------------------------------------------------------------------------


def _port_moe():
    cfg = port_config(JCFGS["moe"])
    bb = Backbone(cfg)
    return cfg, bb, bb.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_matches_forward(per_row):
    cfg, bb, params = _port_moe()
    T, B = 12, 2
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, T)))
    full = bb.apply(params, toks)["logits"]
    assert full.shape == (B, T, cfg.padded_vocab)
    assert not torch.isnan(full).any()
    cache = bb.init_cache(B, T, device="cpu")
    outs = []
    for i in range(T):
        index = torch.full((B,), i) if per_row else i
        lg, cache = bb.decode(params, toks[:, i:i + 1], cache, index)
        outs.append(lg[:, 0])
    # MoE capacity drops differ at T=1, as the reference's test says
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=5e-2)


def test_moe_aux_loss_positive_and_finite():
    cfg, bb, params = _port_moe()
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 16)))
    aux = float(bb.apply(params, toks)["aux"])
    assert np.isfinite(aux) and aux >= 0.0


def test_dense_blocks_return_a_float32_zero_aux():
    """``DecoderBlock.apply`` returns (h, aux[, kv]) in every family: a
    dense block's aux is a float32 0, so the Backbone's aux is 0 there."""
    cfg = port_config(JCFGS["dense"])
    bb = Backbone(cfg)
    params = bb.init(torch.Generator().manual_seed(0))
    out = bb.apply(params, torch.from_numpy(_tokens(cfg.vocab_size, (2, 8))))
    assert out["aux"].dtype == torch.float32 and float(out["aux"]) == 0.0
