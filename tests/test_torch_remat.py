"""``cfg.remat`` in the port (``repro_torch.models.remat``, the twin of the
reference's ``jax.checkpoint`` over its layer scans) on the CPU.

* (a) the port against the JAX package with remat on both sides, for the
  seven families (dense, grouped local:global, moe, ssm, hybrid, audio,
  vlm): the LM GAN's fused gradients within 1e-4 of each leaf's largest
  magnitude, the bound ``tests/test_torch_lm_gan.py`` holds them to
  without remat (a float32 backbone's forward and backward summed in
  another order);
* (b) the port with remat on against remat off, bit for bit: a
  ``FedGAN.round`` on a (1, 2) grid, a DP-SGD round (the per-example vmap
  nested in the agents'), the fused gradients (under the agents' vmap and
  alone, where the generator's ``vjp`` pulls back after its level has
  ended), the plain ``torch.autograd`` route, and the forward's outputs;
  the recompute runs the same ops on the same inputs, so nothing may move;
* (c) the bytes saved for backward on the plain autograd route (distinct
  non-parameter storages, counted by a ``saved_tensors_hooks`` pack hook):
  with remat, at most the wrapped bodies' input bytes plus what the
  unwrapped parts save; an op that also keeps its body's graph fails it;
* (d) the op acts at the reference's eight sites and only there: the
  calls by site, and the parameter storages each call saw; a site skipped,
  or the grouped global layer or the hybrid's shared block wrapped, fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backbone import port_config
from test_torch_lm_gan import _batch, _close, _grads_close
from torch_shared import lm_gan_batch

from repro.configs.registry import get_config as jget_config
from repro.launch.steps import make_lm_gan_task as jmake_lm_gan_task
from repro.models.adversarial import AdversarialLM as JAdversarialLM

from repro_torch.convert import from_jax_params
from repro_torch.core import FedGAN, FedGANConfig
from repro_torch.launch.steps import make_lm_gan_task
from repro_torch.models import Backbone
from repro_torch.models import remat as remat_mod
from repro_torch.models import transformer
from repro_torch.optim import SGD, Adam, constant, equal_timescale
from repro_torch.privacy import DPSGD
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# one tiny config a family: (arch, overrides of its .smoke()); the grouped
# and hybrid ones deep enough for a tail beside their groups
FAMILIES = {
    "dense": ("qwen3-8b", {}),
    "grouped": ("gemma3-4b", {"num_layers": 5}),    # 2 groups (local, global) + 1 tail
    "moe": ("granite-moe-3b-a800m", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-7b", {"num_layers": 5}),     # 1 group (shared, 2 mamba) + 2 tail
    "audio": ("whisper-medium", {}),
    "vlm": ("chameleon-34b", {}),
}


def _jcfg(family, remat=True):
    arch, over = FAMILIES[family]
    return dataclasses.replace(jget_config(arch).smoke(), remat=remat, **over)


def _cfg(family, remat=True):
    return port_config(_jcfg(family, remat))


def _same(a, b):
    """Trees equal in every bit (a comparison that sees the sign of zero)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.contiguous().reshape(-1).view(torch.uint8),
            y.contiguous().reshape(-1).view(torch.uint8)) for x, y in zip(la, lb))


def _init(cfg, seed=0):
    return make_lm_gan_task(cfg).init(torch.Generator().manual_seed(seed))


def _torch_batch(cfg, lead=(2,), T=16, seed=1):
    return tree_map(torch.from_numpy, _batch(cfg, lead + (T,), seed))


# ---------------------------------------------------------------------------
# (a) the port against the JAX package, remat on both sides
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fused_grads_with_remat_match_reference(family):
    """``make_lm_gan_task(cfg).fused_grads`` with ``cfg.remat`` against the
    reference's (``jax.checkpoint`` over its scans), on its weights and
    tokens: D's and G's gradients within 1e-4 of each leaf's largest
    magnitude, the metrics within 1e-5."""
    jcfg = _jcfg(family)
    jp = jax.device_get(JAdversarialLM(jcfg).init(jax.random.key(0)))
    b = _batch(jcfg, (2, 16))
    jgd, jgg, jm = jax.device_get(jax.jit(jmake_lm_gan_task(jcfg).fused_grads)(
        jp, tree_map(jnp.asarray, b), jax.random.key(0)))
    remat_mod.reset_calls()
    gd, gg, m = make_lm_gan_task(port_config(jcfg)).fused_grads(
        from_jax_params(jp, device="cpu"), tree_map(torch.from_numpy, b))
    assert remat_mod.CALLS, "the port's forward took no remat op"
    assert _grads_close(gd, jgd) == 0
    assert _grads_close(gg, jgg) == 0
    for k in m:
        _close(m[k].item(), jm[k], 1e-5)


# ---------------------------------------------------------------------------
# (b) remat on against remat off, bit for bit
# ---------------------------------------------------------------------------


def _fed(cfg, K=2, dp=None, opt=Adam):
    return FedGAN(make_lm_gan_task(cfg),
                  FedGANConfig(agent_grid=(1, 2), sync_interval=K, dp=dp),
                  opt_g=opt(), opt_d=opt(), scales=equal_timescale(constant(1e-3)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_round_with_remat_is_the_round_without_bit_for_bit(family):
    """``FedGAN.round`` (K = 2, Adam, the FedAvg sync) on a (1, 2) grid from
    one state and one set of batches: the new state and the metrics with
    remat equal those without, bit for bit."""
    off, on = _fed(_cfg(family, False)), _fed(_cfg(family, True))
    state = off.init_state(torch.Generator().manual_seed(0), device="cpu")
    batches = tree_map(torch.from_numpy, lm_gan_batch(_jcfg(family), 2, (1, 2), 2, 16))
    want = off.round(state, batches)
    remat_mod.reset_calls()
    got = on.round(state, batches)
    assert remat_mod.CALLS
    assert _same(got, want)


@pytest.mark.parametrize("family", ["dense", "ssm", "audio"])
def test_dp_round_with_remat_is_the_round_without_bit_for_bit(family):
    """A DP-SGD round (clip 1, sigma 1: the per-example ``vmap`` inside the
    agents' ``vmap(grad)``), its noise from one seeded generator: bit for
    bit with and without remat."""
    dp = DPSGD(clip=1.0, noise_multiplier=1.0)
    off, on = _fed(_cfg(family, False), dp=dp, opt=SGD), _fed(_cfg(family, True), dp=dp,
                                                               opt=SGD)
    state = off.init_state(torch.Generator().manual_seed(0), device="cpu")
    batches = tree_map(torch.from_numpy, lm_gan_batch(_jcfg(family), 2, (1, 2), 2, 8))
    want = off.round(state, batches, torch.Generator().manual_seed(3))
    remat_mod.reset_calls()
    got = on.round(state, batches, torch.Generator().manual_seed(3))
    assert remat_mod.CALLS
    assert _same(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("vmapped", [True, False], ids=["agents_vmap", "alone"])
def test_fused_grads_with_remat_are_the_grads_without_bit_for_bit(family, vmapped):
    """The LM GAN's fused gradients (the generator's ``torch.func.vjp``)
    under the agents' ``vmap`` and alone (its pull-back then runs after
    the transform's level has ended): bit for bit with and without remat."""
    params = _init(_cfg(family))
    batch = _torch_batch(_cfg(family), (2, 2) if vmapped else (2,))
    out = []
    for remat in (False, True):
        fused = make_lm_gan_task(_cfg(family, remat)).fused_grads
        if vmapped:
            two = tree_map(lambda x: torch.stack([x, 1.01 * x]), params)
            out.append(torch.func.vmap(fused)(two, batch))
        else:
            out.append(fused(params, batch))
    assert _same(out[1], out[0])


@pytest.mark.parametrize("family", ["dense", "grouped", "hybrid", "audio"])
def test_plain_autograd_with_remat_is_autograd_without_bit_for_bit(family):
    """The route the agents' gradients take on a submesh of several ranks
    (``torch.autograd`` on the leaves, no ``torch.func`` transform): the
    generator loss's gradients bit for bit with and without remat."""
    params = _init(_cfg(family))["gen"]
    batch = _torch_batch(_cfg(family))
    out = []
    for remat in (False, True):
        leaves, treedef = tree_flatten(tree_map(lambda x: x.detach().requires_grad_(), params))
        o = Backbone(_cfg(family, remat)).apply(tree_unflatten(treedef, leaves),
                                                batch["tokens"],
                                                encoder_frames=batch.get("frames"))
        loss = (o["logits"] ** 2).mean() + o["aux"]
        out.append(torch.autograd.grad(loss, leaves))
    assert _same(out[1], out[0])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_with_remat_is_the_forward_without(family):
    """``Backbone.apply`` with grad on (through the op) and with grad off
    (the body as it is, no op called), and ``prefill``: every output bit
    for bit the forward's without remat."""
    params = _init(_cfg(family))["gen"]
    batch = _torch_batch(_cfg(family))
    kw = dict(encoder_frames=batch.get("frames"))
    want = Backbone(_cfg(family, False)).apply(params, batch["tokens"], **kw)
    bb = Backbone(_cfg(family, True))
    remat_mod.reset_calls()
    assert _same(bb.apply(params, batch["tokens"], **kw), want)
    assert remat_mod.CALLS
    remat_mod.reset_calls()
    with torch.no_grad():
        assert _same(bb.apply(params, batch["tokens"], **kw), want)
        assert _same(bb.prefill(params, batch["tokens"], **kw),
                     Backbone(_cfg(family, False)).prefill(params, batch["tokens"], **kw))
    assert remat_mod.CALLS == {}


def test_remat_raises_where_it_has_no_rule():
    """No quiet fallback: forward-mode AD (``torch.func.jvp``) through a
    remat body has no rule, and raises rather than running unwrapped."""
    cfg = _cfg("dense")
    params = _init(cfg)["gen"]
    tokens = _torch_batch(cfg)["tokens"]
    bb = Backbone(cfg)
    with pytest.raises(RuntimeError):
        torch.func.jvp(lambda p: bb.apply(p, tokens)["logits"], (params,),
                       (tree_map(torch.ones_like, params),))


# ---------------------------------------------------------------------------
# (c) the bytes saved for backward
# ---------------------------------------------------------------------------


def _saved_bytes(cfg, params, batch, inside=None):
    """Bytes of the distinct non-parameter storages the plain autograd
    route saves for backward in a generator forward and loss; with
    ``inside`` (a one-element list the caller sets while a wrapped body
    runs) only those saved outside such bodies."""
    leaves, treedef = tree_flatten(tree_map(lambda x: x.detach().requires_grad_(), params))
    own = {x.untyped_storage().data_ptr() for x in leaves}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own and not (inside and inside[0]):
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = Backbone(cfg).apply(tree_unflatten(treedef, leaves), batch["tokens"],
                                encoder_frames=batch.get("frames"))
        loss = (o["logits"] ** 2).mean() + o["aux"]
    return sum(seen.values()), loss


def _outside_bytes(cfg_off, params, batch, monkeypatch):
    """What the unwrapped parts save: the forward without remat, the saves
    made while one of the eight bodies runs left out."""
    inside = [False]

    def marked(self, fn, site):
        def run(*args):
            inside[0] = True
            try:
                return fn(*args)
            finally:
                inside[0] = False
        return run

    with monkeypatch.context() as m:
        m.setattr(Backbone, "_maybe_remat", marked)
        return _saved_bytes(dataclasses.replace(cfg_off, remat=True), params, batch,
                            inside)[0]


def _input_bytes(cfg, batch, calls):
    """The wrapped bodies' input bytes: the carry of each call (the
    encoder's over the frames), and the audio decoder's memory once."""
    B, T = batch["tokens"].shape
    row = B * cfg.d_model * torch.empty((), dtype=cfg.dtype).element_size()
    S = batch["frames"].shape[1] if cfg.family == "audio" else 0
    enc = calls.get("encoder", 0)
    return (sum(calls.values()) - enc) * T * row + enc * S * row + (S * row if S else 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_saves_only_the_wrapped_bodies_inputs(family, monkeypatch):
    """With remat, the storages saved for backward are at most the wrapped
    bodies' inputs plus what the unwrapped parts save (measured without
    remat, the bodies' own saves left out); without remat they are more."""
    cfg = _cfg(family)
    params = _init(cfg)["gen"]
    batch = _torch_batch(cfg, T=32)
    remat_mod.reset_calls()
    got, _ = _saved_bytes(cfg, params, batch)
    calls = dict(remat_mod.CALLS)
    outside = _outside_bytes(_cfg(family, False), params, batch, monkeypatch)
    bound = _input_bytes(cfg, batch, calls) + outside
    assert got <= bound, (got, bound)
    assert _saved_bytes(_cfg(family, False), params, batch)[0] > bound


def test_an_op_that_keeps_its_body_graph_fails_the_saved_bytes_bound(monkeypatch):
    """A planted op whose forward records its body's graph (and keeps it)
    saves the body's intermediates: the bound above sees it."""
    kept = []

    class Keeps(remat_mod.Remat):
        @staticmethod
        def forward(body, *leaves):
            with torch.enable_grad():
                out = body(*leaves)
            kept.append(out)
            return tuple(o.detach() for o in out)

    cfg = _cfg("ssm")
    params = _init(cfg)["gen"]
    batch = _torch_batch(cfg, T=32)
    outside = _outside_bytes(_cfg("ssm", False), params, batch, monkeypatch)
    monkeypatch.setattr(remat_mod, "Remat", Keeps)
    remat_mod.reset_calls()
    got, _ = _saved_bytes(cfg, params, batch)
    assert kept
    assert got > _input_bytes(cfg, batch, dict(remat_mod.CALLS)) + outside


# ---------------------------------------------------------------------------
# (d) the eight sites and only those
# ---------------------------------------------------------------------------


def _expected_sites(cfg):
    bb = Backbone(cfg)
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"ssm": L}, ("blocks",)
    if cfg.family == "hybrid":
        return ({"hybrid_mamba": bb.n_groups * (cfg.hybrid_period - 1),
                 "hybrid_tail": bb.n_tail}, ("mamba", "mamba_tail"))
    if cfg.family == "audio":
        return {"encoder": cfg.encoder_layers, "audio_decoder": L}, ("enc_blocks", "blocks")
    if bb.grouped:
        return ({"local": bb.n_groups * cfg.local_global_ratio, "tail": bb.n_tail},
                ("local", "tail"))
    return {"decoder": L}, ("blocks",)


def _sites_seen(cfg, params, batch, monkeypatch):
    """(calls by site, the parameter storages the op's calls saw) of one
    generator forward with grad on."""
    seen = set()
    apply = remat_mod.Remat.apply

    def spy(body, *leaves):
        seen.update(x.untyped_storage().data_ptr() for x in leaves)
        return apply(body, *leaves)

    monkeypatch.setattr(remat_mod.Remat, "apply", spy)
    remat_mod.reset_calls()
    Backbone(cfg).apply(params, batch["tokens"], encoder_frames=batch.get("frames"))
    monkeypatch.setattr(remat_mod.Remat, "apply", apply)
    own = {x.untyped_storage().data_ptr() for x in tree_leaves(params)}
    return dict(remat_mod.CALLS), seen & own


def _check_sites(family, monkeypatch):
    cfg = _cfg(family)
    params = _init(cfg)["gen"]
    batch = _torch_batch(cfg)
    calls, seen = _sites_seen(cfg, params, batch, monkeypatch)
    want_calls, stacks = _expected_sites(cfg)
    want_calls = {k: v for k, v in want_calls.items() if v}
    want = {x.untyped_storage().data_ptr() for k in stacks for x in tree_leaves(params[k])}
    return calls == want_calls and seen == want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_acts_at_the_references_sites(family, monkeypatch):
    """One forward's op calls by site, and the parameter storages they saw:
    exactly the stacks the reference checkpoints (ssm blocks, the audio
    encoder and decoder blocks, dense/moe/vlm blocks, the grouped local
    and tail layers, the hybrid's mamba and tail layers), never the grouped
    global layer, the hybrid's shared block, the head or the embedding."""
    assert _check_sites(family, monkeypatch)


@pytest.mark.parametrize("family,site", [
    ("dense", "decoder"), ("grouped", "local"), ("grouped", "tail"), ("ssm", "ssm"),
    ("hybrid", "hybrid_mamba"), ("hybrid", "hybrid_tail"), ("audio", "encoder"),
    ("audio", "audio_decoder")])
def test_a_skipped_site_fails_the_site_check(family, site, monkeypatch):
    orig = Backbone._maybe_remat
    monkeypatch.setattr(Backbone, "_maybe_remat",
                        lambda self, fn, s: fn if s == site else orig(self, fn, s))
    assert not _check_sites(family, monkeypatch)


@pytest.mark.parametrize("family,stack", [("grouped", "global"), ("hybrid", "shared_attn")])
def test_a_wrapped_global_or_shared_block_fails_the_site_check(family, stack, monkeypatch):
    """A planted fault that checkpoints the grouped global layer, or the
    hybrid's shared attention block, as well."""
    cfg = _cfg(family)
    params = _init(cfg)["gen"]
    forbidden = {x.untyped_storage().data_ptr() for x in tree_leaves(params[stack])}
    apply = transformer.DecoderBlock.apply

    def planted(self, p, h, **kw):
        if any(x.untyped_storage().data_ptr() in forbidden for x in tree_leaves(p)):
            return remat_mod.remat(lambda pp, hh: apply(self, pp, hh, **kw), "local")(p, h)
        return apply(self, p, h, **kw)

    monkeypatch.setattr(transformer.DecoderBlock, "apply", planted)
    batch = _torch_batch(cfg)
    calls, seen = _sites_seen(cfg, params, batch, monkeypatch)
    want_calls, stacks = _expected_sites(cfg)
    want = {x.untyped_storage().data_ptr() for k in stacks for x in tree_leaves(params[k])}
    assert not (calls == {k: v for k, v in want_calls.items() if v} and seen == want)


def test_remat_field_is_on_by_default_and_off_in_smoke():
    """The port's ``ArchConfig.remat`` defaults as the reference's: on for
    every registry config, off in ``.smoke()``."""
    from repro_torch.configs.registry import get_config, list_archs
    assert all(get_config(a).remat for a in list_archs())
    assert not any(get_config(a).smoke().remat for a in list_archs())
    assert np.all([jget_config(a).remat for a in list_archs()])
