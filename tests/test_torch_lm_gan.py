"""The port's LM GAN (FedGAN's Algorithm 1 with an assigned backbone as the
generator) on the CPU against the JAX reference: the token streams, the
feature discriminator, the adversarial losses, the fused gradients and one
FedGAN round of each arch the registry gained, then the port's own entry
points (``run_arch_smoke``, the train CLI's ``--arch``, the
``federated_backbone`` twin) and the walkthrough train, checkpoint, serve.

Both packages get the same numpy inputs and the same weights (the
reference's, through ``from_jax_params``).  Tolerances, with their
reasons:
* ``sample_agent_tokens``: bit for bit (the same Threefry bits);
* the discriminator's logits and gradients: 1e-5 of the largest magnitude
  (``torch_shared._parity``), float32 both sides;
* the losses: 1e-5 relative; the fused gradients: 1e-4 of each leaf's
  largest magnitude (a float32 backbone's forward and backward, summed in
  another order through every layer, as the backbone's logits are held to
  2e-4 in ``tests/test_torch_backbone.py``);
* the round: ``torch_shared.round_mismatches``, the bounds every paper
  experiment's round is held to, under SGD (1e-5 of the leaf's magnitude)
  as the reference's own round test runs it; why not under Adam is
  ``test_adam_bounds_do_not_hold_the_lm_gan_reference_to_itself``.
"""
import dataclasses
import json
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_backbone import port_config
from torch_shared import _parity, lm_gan_batch, one_torch_thread, round_mismatches, \
    sync_cases  # noqa: F401

from repro.configs.registry import get_config as jget_config, list_archs as jlist_archs
from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig
from repro.data.synthetic import sample_agent_tokens as jsample_agent_tokens
from repro.launch.steps import make_lm_gan_task as jmake_lm_gan_task
from repro.models.adversarial import AdversarialLM as JAdversarialLM
from repro.models.adversarial import FeatureDiscriminator as JFeatureDiscriminator
from repro.optim import SGD as JSGD, Adam as JAdam, constant as jconstant, \
    equal_timescale as jequal_timescale

from repro_torch import prng
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import FedGAN, FedGANConfig
from repro_torch.data.synthetic import sample_agent_tokens
from repro_torch.launch import train
from repro_torch.launch.steps import make_lm_gan_task
from repro_torch.models import Backbone
from repro_torch.models.adversarial import AdversarialLM, FeatureDiscriminator
from repro_torch.optim import SGD, constant, equal_timescale
from repro_torch.tree import tree_leaves, tree_map

NEW_ARCHS = ["mixtral-8x22b", "qwen3-8b", "phi4-mini-3.8b", "glm4-9b",
             "granite-moe-3b-a800m"]
FAMILY_ARCHS = ["zamba2-7b", "whisper-medium", "chameleon-34b"]   # hybrid, audio, vlm


def _smoke(arch):
    """The arch's ``.smoke()`` config in both packages."""
    jcfg = jget_config(arch).smoke()
    return jcfg, port_config(jcfg)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the token streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,agent,num_agents,vocab,n,T", [
    (0, 0, 4, 512, 256, 32), (0, 3, 4, 512, 256, 32), (7, 1, 4, 49_155, 64, 48),
    (3, 5, 8, 100, 17, 5), (2, 1, 2, 3, 8, 8)])
def test_sample_agent_tokens_bit_for_bit(seed, agent, num_agents, vocab, n, T):
    """The reference's tokens for the same key, agent and sizes, bit for
    bit: both the agent's slice (``base + offset``) and the 30% shared
    head, drawn (as there) from one key for the tokens and the choice."""
    want = np.asarray(jsample_agent_tokens(jax.random.key(seed), n, T, vocab,
                                           agent=agent, num_agents=num_agents))
    got = sample_agent_tokens(prng.key(seed), n, T, vocab, agent=agent,
                              num_agents=num_agents)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < vocab


# ---------------------------------------------------------------------------
# the discriminator, the losses, the fused gradients
# ---------------------------------------------------------------------------

_CASES = ["granite-moe-3b-a800m", "qwen3-8b", "gemma3-4b", "mamba2-2.7b"]


def _batch(jcfg, shape, seed=1):
    """Tokens of ``shape`` (..., T) and, for the audio family, encoder
    frames (..., S_enc, d_model), numpy."""
    out = {"tokens": _tokens(jcfg.vocab_size, shape, seed)}
    if jcfg.family == "audio":
        rng = np.random.default_rng(seed + 100)
        out["frames"] = (0.1 * rng.standard_normal(
            shape[:-1] + (jcfg.encoder_seq, jcfg.d_model))).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", _CASES)
def test_feature_discriminator_matches_jax(arch):
    """Logits and the gradients wrt D's params and the features, within
    1e-5 (``_parity``)."""
    jcfg, tcfg = _smoke(arch)
    feats = np.random.default_rng(2).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    _parity(JFeatureDiscriminator(jcfg), FeatureDiscriminator(tcfg), [feats])


def _lm_pair(arch, seed=0):
    jcfg, tcfg = _smoke(arch)
    jparams = jax.device_get(JAdversarialLM(jcfg).init(jax.random.key(seed)))
    return jcfg, tcfg, jparams, from_jax_params(jparams, device="cpu")


@pytest.mark.parametrize("arch", _CASES + FAMILY_ARCHS)
def test_adversarial_losses_match_jax(arch):
    """``lm_loss``, ``disc_loss`` and ``gen_loss`` (its total and its lm,
    adv and aux parts) on the same weights and tokens (and, audio, frames),
    within 1e-5."""
    jcfg, tcfg, jp, tp = _lm_pair(arch)
    jm, tm = JAdversarialLM(jcfg), AdversarialLM(tcfg)
    b = _batch(jcfg, (2, 16))
    tt, jt = torch.from_numpy(b["tokens"]), jnp.asarray(b["tokens"])
    tf = torch.from_numpy(b["frames"]) if "frames" in b else None
    jf = jnp.asarray(b["frames"]) if "frames" in b else None
    tfake, tlogits, _ = tm.fake_features(tp["gen"], tt, tf)
    jfake, jlogits, _ = jm.fake_features(jp["gen"], jt, jf)
    _close(tm.lm_loss(tlogits, tt).item(), jm.lm_loss(jlogits, jt), 1e-5)
    _close(tm.disc_loss(tp["disc"], tm.real_features(tp["gen"], tt), tfake).item(),
           jm.disc_loss(jp["disc"], jm.real_features(jp["gen"], jt), jfake), 1e-5)
    ttotal, tparts = tm.gen_loss(tp["gen"], tp["disc"], tt, tf)
    jtotal, jparts = jm.gen_loss(jp["gen"], jp["disc"], jt, jf)
    _close(ttotal.item(), jtotal, 1e-5)
    for k in ("lm", "adv", "aux"):
        _close(tparts[k].item(), jparts[k], 1e-5)


def _fused_pair(arch, tcfg_fault=None):
    jcfg, tcfg, jp, tp = _lm_pair(arch)
    b = _batch(jcfg, (2, 16))
    want = jax.device_get(jax.jit(jmake_lm_gan_task(jcfg).fused_grads)(
        jp, tree_map(jnp.asarray, b), jax.random.key(0)))
    task = make_lm_gan_task(tcfg_fault(tcfg) if tcfg_fault else tcfg)
    batch = tree_map(torch.from_numpy, b)
    got = task.fused_grads(tp, batch)
    return task, tp, batch, got, want


def _grads_close(got, want, rel=1e-4):
    """Every leaf within ``rel`` of its largest |want|; returns the
    number of leaves outside."""
    off = 0
    for t, j in zip(tree_leaves(to_jax_params(got)), jax.tree_util.tree_leaves(want)):
        j = np.asarray(j)
        off += int(np.abs(t - j).max() > rel * max(float(np.abs(j).max()), 1e-30))
    return off


@pytest.mark.parametrize("arch", _CASES + ["mixtral-8x22b"] + FAMILY_ARCHS)
def test_fused_grads_match_reference(arch):
    """``make_lm_gan_task(cfg).fused_grads`` (one generator forward through
    ``torch.func.vjp``) against the reference's: D's and G's gradients
    within 1e-4 of each leaf's largest magnitude, and the metrics."""
    _, _, _, (gd, gg, m), (jgd, jgg, jm) = _fused_pair(arch)
    assert len(tree_leaves(gg)) == len(jax.tree_util.tree_leaves(jgg))
    assert _grads_close(gd, jgd) == 0
    assert _grads_close(gg, jgg) == 0
    assert sorted(m) == sorted(jm) == ["adv", "aux", "d_loss", "g_loss", "lm"]
    for k in m:
        _close(m[k].item(), jm[k], 1e-5)


def test_fused_grads_reject_a_dropped_aux_cotangent():
    """A port that pulls no cotangent (or another weight) back through the
    MoE router's aux loss differs from the reference's generator gradient:
    the parity above sees it."""
    fault = lambda c: dataclasses.replace(c, router_aux_weight=0.0)  # noqa: E731
    _, _, _, (_, gg, _), (_, jgg, _) = _fused_pair("granite-moe-3b-a800m", fault)
    assert _grads_close(gg, jgg) > 0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-8b", "whisper-medium"])
def test_fused_grads_match_the_separate_losses(arch):
    """The port twin of the reference's ``test_adversarial_pair_losses_
    finite``: the fused gradients are finite and equal the gradients of the
    separate ``disc_loss`` and ``gen_loss`` (within 1e-5 of each leaf)."""
    task, tp, batch, (gd, gg, m), _ = _fused_pair(arch)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves((gd, gg)))
    assert np.isfinite(m["d_loss"].item()) and np.isfinite(m["g_loss"].item())
    gd2 = torch.func.grad(lambda d: task.disc_loss({**tp, "disc": d}, batch))(tp["disc"])
    gg2 = torch.func.grad(lambda g: task.gen_loss({**tp, "gen": g}, batch))(tp["gen"])
    for a, b in zip(tree_leaves((gd, gg)), tree_leaves((gd2, gg2))):
        _close(a.numpy(), b.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# one LM GAN round of each new arch against the reference's
# ---------------------------------------------------------------------------

_K, _GRID, _B, _T = 2, (1, 2), 2, 16
_OPTS = {"sgd": (JSGD, SGD, 1e-3)}


def _round_mismatches(arch, opt):
    """One round (K = 2 local steps, then the FedAvg sync) of the LM GAN at
    the arch's ``.smoke()`` config on a (1, 2) grid, from the reference's
    init, on the same tokens in both packages, held to
    ``round_mismatches``; the first step's gradients from the reference's
    fused task."""
    jopt, topt, lr = _OPTS[opt]
    jcfg, tcfg = _smoke(arch)
    jfed = JFedGAN(jmake_lm_gan_task(jcfg), JConfig(agent_grid=_GRID, sync_interval=_K),
                   opt_g=jopt(), opt_d=jopt(), scales=jequal_timescale(jconstant(lr)))
    tfed = FedGAN(make_lm_gan_task(tcfg), FedGANConfig(agent_grid=_GRID, sync_interval=_K),
                  opt_g=topt(), opt_d=topt(), scales=equal_timescale(constant(lr)))
    jstate = jfed.init_state(jax.random.key(0))
    batch = lm_gan_batch(jcfg, _K, _GRID, _B, _T)
    jend, jm = jax.jit(jfed.round)(jstate, tree_map(jnp.asarray, batch),
                                   jnp.zeros((_K,) + _GRID, jnp.uint32))
    start = jax.device_get(jstate)
    n = _GRID[0] * _GRID[1]
    flat = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x).reshape((n,) + x.shape[2:]), t)
    gd, gg, _ = jax.jit(jax.vmap(lambda p, b: jfed.task.fused_grads(p, b, None)))(
        flat(start["params"]), flat(tree_map(lambda x: x[0], batch)))
    tstate, tm = tfed.round(from_jax_params(start, device="cpu"),
                            tree_map(torch.from_numpy, batch))
    losses = ((tm["d_loss"][0].item(), tm["g_loss"][0].item()),
              (float(jm["d_loss"][0]), float(jm["g_loss"][0])))
    exp = types.SimpleNamespace(opt=opt, lr_d=lr, lr_g=lr)
    return round_mismatches(exp, _K, to_jax_params(tstate), jax.device_get(jend),
                            jax.device_get({"disc": gd, "gen": gg}), losses)


@pytest.mark.parametrize("arch", NEW_ARCHS + FAMILY_ARCHS)
def test_lm_gan_round_matches_reference(arch):
    """The reference's ``tests/test_arch_smoke.py`` round (a (1, 2) grid,
    K = 2, batch 2 of 16 tokens, SGD at 1e-3 as there), held to the
    reference's round elementwise; every agent synced."""
    bad, (ratio, path) = _round_mismatches(arch, "sgd")
    assert bad == [], (bad, ratio, path)


def test_adam_bounds_do_not_hold_the_lm_gan_reference_to_itself():
    """Why the LM GAN round is held under SGD and not under Adam: some
    first-step gradient elements of these nets are 1e-8 to 3e-7 (Adam's
    eps is 1e-8) where their leaf's largest is about 0.1, so they are
    rounding noise, yet above the 1e-5-of-the-leaf cut below which
    ``round_mismatches`` treats a gradient as zero to rounding.  Adam maps
    such noise onto steps anywhere in [-lr, lr].  The reference against
    itself, on the same tokens with each agent's two rows swapped (the same
    arithmetic rounded in another order), already departs past the Adam
    bound at K = 1."""
    jcfg, _ = _smoke("qwen3-8b")
    jfed = JFedGAN(jmake_lm_gan_task(jcfg), JConfig(agent_grid=_GRID, sync_interval=1),
                   opt_g=JAdam(), opt_d=JAdam(), scales=jequal_timescale(jconstant(1e-3)))
    jstate = jfed.init_state(jax.random.key(0))
    toks = _tokens(jcfg.vocab_size, (1,) + _GRID + (_B, _T))
    jround = jax.jit(jfed.round)
    seeds = jnp.zeros((1,) + _GRID, jnp.uint32)
    want, wm = jround(jstate, {"tokens": jnp.asarray(toks)}, seeds)
    got, gm = jround(jstate, {"tokens": jnp.asarray(toks[:, :, :, ::-1])}, seeds)
    n = _GRID[0] * _GRID[1]
    flat = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x).reshape((n,) + x.shape[2:]), t)
    gd, gg, _ = jax.jit(jax.vmap(lambda p, b: jfed.task.fused_grads(p, b, None)))(
        flat(jstate["params"]), flat({"tokens": toks[0]}))
    losses = tuple((float(m["d_loss"][0]), float(m["g_loss"][0])) for m in (gm, wm))
    exp = types.SimpleNamespace(opt="adam", lr_d=1e-3, lr_g=1e-3)
    bad, (ratio, _) = round_mismatches(exp, 1, jax.device_get(got), jax.device_get(want),
                                       jax.device_get({"disc": gd, "gen": gg}), losses)
    assert bad != [] and ratio > 2


# ---------------------------------------------------------------------------
# the port's entry points
# ---------------------------------------------------------------------------


def test_registry_has_seven_of_the_references_ten():
    """The port twin of ``test_registry_has_all_ten`` (the name recalls the
    seven archs the registry held before the hybrid, audio and vlm
    families): now all ten, every one the reference's config."""
    archs = list_archs()
    assert len(archs) == 10 and archs == jlist_archs()
    assert {get_config(a).family for a in archs} == \
        {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}
    for a in archs:
        assert get_config(a) == port_config(jget_config(a))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b", "mamba2-2.7b",
                                  "whisper-medium"])
def test_run_arch_smoke(arch):
    """``run_arch_smoke`` at its defaults but 2 rounds of K = 2: finite
    losses (with ``lm`` per round), params moved and synced."""
    spec = train.arch_smoke_spec(arch, steps=4, K=2, seed=0, device="cpu", log_every=0)
    assert (spec.agent_grid, spec.batch_size, spec.K) == ((1, 4), 8, 2)
    assert all(d["tokens"].shape == (256, 32) for d in spec.agent_data)
    cfg = get_config(arch).smoke()
    if cfg.family == "audio":   # each agent's frames, the port's own seeded draws
        assert all(tuple(d["frames"].shape) == (256, cfg.encoder_seq, cfg.d_model)
                   for d in spec.agent_data)
        assert not torch.equal(spec.agent_data[0]["frames"], spec.agent_data[1]["frames"])
    fed = spec.build()
    start = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    result = train.run_arch_smoke(arch, steps=4, K=2, seed=0, device="cpu", log_every=0)
    assert len(result.history) == 2
    assert all(np.isfinite(v) for m in result.history for v in m.values())
    assert {"lm", "adv", "aux"} <= set(result.history[0])
    before = tree_leaves(start["params"]["gen"])[0]
    after = tree_leaves(result.state["params"]["gen"])[0]
    assert not torch.equal(before, after)
    for x in tree_leaves(result.state["params"]):
        assert (x == x[:1, :1]).all()


def test_arch_smoke_tokens_are_the_references(arch="qwen3-8b"):
    """The run's agent data is the reference's ``arch_smoke_spec`` data,
    token for token, for the same seed."""
    from repro.launch.train import arch_smoke_spec as jspec
    got = train.arch_smoke_spec(arch, steps=4, K=2, seed=3, device="cpu")
    want = jspec(arch, steps=4, K=2, seed=3)
    for g, w in zip(got.agent_data, want.agent_data):
        np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))


def test_arch_smoke_audio_tokens_are_the_references():
    """whisper-medium's agents hold the reference's tokens too; their
    frames are the port's own draws (``sample_audio_frames``)."""
    test_arch_smoke_tokens_are_the_references("whisper-medium")


def test_train_cli_arch(capsys):
    """``python -m repro_torch.launch.train --arch ... --device cpu``: the
    acceptance command's shape, in-process; and its refusals."""
    result = train.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu",
                         "--steps", "4", "--K", "2"])
    out = capsys.readouterr().out
    assert "round     1/2" in out
    assert json.loads(out.strip().splitlines()[-1])["rounds"] == 2
    assert len(result.history) == 2
    for argv in (["--arch", "qwen3-8b", "--eval-every", "2"],
                 ["--arch", "qwen3-8b", "--experiment", "toy_2d"], []):
        with pytest.raises(SystemExit):
            train.main(argv + ["--device", "cpu"])
    result = train.main(["--arch", "zamba2-7b", "--device", "cpu", "--steps", "2", "--K", "1"])
    assert len(result.history) == 2
    with pytest.raises(KeyError, match="unknown arch"):
        train.main(["--arch", "no-such-arch", "--device", "cpu"])


def test_federated_backbone_runs_on_the_cpu():
    """``python -m repro_torch.federated_backbone --device cpu`` as a user
    runs it (a process of its own), a few rounds: the accounting line,
    per-round losses with ``lm``, the agents synced."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.federated_backbone", "--device", "cpu",
         "--arch", "granite-moe-3b-a800m", "--steps", "6", "--K", "2"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[1].startswith("§3.2 accounting: M=")
    assert sum("lm=" in ln for ln in lines) == 3
    assert lines[-1] == "agents synced after final round: True (expected True)"


def test_federated_backbone_rounds_take_the_references_batches():
    """The twin's round inputs are the reference example's: its tokens and
    ``FederatedRounds`` minibatches, bit for bit, for the same keys."""
    from repro.data import FederatedRounds as JRounds
    from repro_torch.data import FederatedRounds
    vocab, B, K = 512, 4, 5
    jrng, trng = jax.random.key(1), prng.key(1)
    jdata = [{"tokens": jsample_agent_tokens(jrng, 512, 32, vocab, agent=i, num_agents=B)}
             for i in range(B)]
    tdata = [{"tokens": sample_agent_tokens(trng, 512, 32, vocab, agent=i, num_agents=B)}
             for i in range(B)]
    jr = JRounds(jdata, (1, B), batch_size=8, sync_interval=K)
    tr = FederatedRounds(tdata, (1, B), batch_size=8, sync_interval=K)
    for _ in range(2):
        jrng, jrb = jax.random.split(jrng)
        trng, trb = prng.split(trng)
        jb, _ = jr.round_batches(jrb)
        tb, _ = tr.round_batches(trb)
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))


def test_train_then_checkpoint_then_serve():
    """The two-terminal walkthrough on the CPU: ``run_arch_smoke`` writes
    checkpoints, a ``ServeEngine`` on that directory picks up the last one
    (``CheckpointWatcher``, agent (0, 0)'s synced generator), and the first
    logits it samples from are ``Backbone.apply``'s on those params (a
    prompt of one MoE group, prefilled exactly), within 1e-5."""
    from repro_torch.serve import ServeEngine
    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch).smoke()
    prompt = _tokens(cfg.vocab_size, (cfg.moe_group_size,), seed=9).tolist()

    class Recording(ServeEngine):
        def _sample(self, row, req):
            self.rows.append(np.array(row[:self.cfg.vocab_size]))
            return super()._sample(row, req)

    with tempfile.TemporaryDirectory() as d:
        result = train.run_arch_smoke(arch, steps=4, K=2, seed=0, ckpt_dir=d,
                                      device="cpu", log_every=0)
        eng = Recording(cfg, max_batch=2, max_seq=64, ckpt_dir=d, device="cpu")
        eng.rows = []
        assert eng.loaded_step == 4
        served = tree_map(lambda x: x[0, 0], result.state["params"]["gen"])
        for a, b in zip(tree_leaves(eng.params), tree_leaves(served)):
            assert torch.equal(a, b)
        rid = eng.submit(prompt, max_new_tokens=3)
        assert len(eng.run()[rid].generated) == 3
    want = Backbone(cfg).apply(served, torch.tensor([prompt]))["logits"][0, -1]
    _close(eng.rows[0], want[:cfg.vocab_size].numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the in-place holds the card phase runs (torch_shared.held_sync_kernels)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "fused", "composed"])
def test_held_sync_kernels_see_every_sync_call_of_the_round(case):
    """The card phase's count of sync launches a round, rehearsed on the
    CPU: around two LM GAN rounds of granite's ``.smoke()`` config, the
    holds see every wrapper call the sync makes, as many as the path
    implies (on the CPU each wrapper computes its plain version, so each
    hold compares it to itself)."""
    from torch_shared import held_sync_kernels
    arch = "granite-moe-3b-a800m"
    L = len(tree_leaves(make_lm_gan_task(get_config(arch).smoke()).init(
        torch.Generator().manual_seed(0))))
    strategy, per_round = sync_cases(L)[case]
    with held_sync_kernels(columns=1 << 12) as held:
        result = train.run_arch_smoke(arch, steps=2, K=1, seed=0, strategy=strategy,
                                      device="cpu", log_every=0)
    assert {k: v["calls"] for k, v in held.items()} == {k: 2 * v for k, v in per_round.items()}
    embed = get_config(arch).smoke()
    assert case == "composed" or max(held[next(iter(per_round))]["widths"]) > \
        2 * embed.padded_vocab * embed.d_model
    for x in tree_leaves(result.state["params"]):
        assert (x == x[:1, :1]).all()


@pytest.mark.parametrize("kernel", ["fedavg", "quant", "dequant", "pack4", "unpack4", "qsync"])
def test_held_sync_kernels_reject_a_planted_fault(kernel, monkeypatch):
    """A kernel wrapper that returns one element off (the last column, past
    the first chunk) fails its hold."""
    from repro_torch.comm import IntQuant, get_codec
    from repro_torch.dist import collectives
    from repro_torch.kernels.qpack import kernel as pk
    from repro_torch.kernels.qsync import kernel as qk
    from torch_shared import held_sync_kernels

    def planted(fn):
        def wrong(*args, **kwargs):
            out = fn(*args, **kwargs)
            first = out[0] if isinstance(out, tuple) else out
            flat = first.view(-1)
            flat[-1] = flat[-1] + 1
            return out
        return wrong

    if kernel == "fedavg":
        monkeypatch.setitem(collectives._REDUCE, torch.float32,
                            planted(collectives._REDUCE[torch.float32]))
    else:
        where = qk if kernel == "qsync" else pk
        monkeypatch.setattr(where, f"{kernel}_flat", planted(getattr(where, f"{kernel}_flat")))
    codec = {"fedavg": None, "qsync": IntQuant(bits=8), "quant": IntQuant(bits=8),
             "dequant": IntQuant(bits=8)}.get(kernel, get_codec("topk+int4", fraction=0.5))
    x = torch.randn((1, 3, 1000), generator=torch.Generator().manual_seed(0))
    w = torch.full((1, 3), 1.0 / 3)
    with pytest.raises(AssertionError):
        with held_sync_kernels(columns=256):
            if codec is None:
                collectives.average_agents({"x": x}, w)
            else:
                collectives.coded_sync({"x": x}, w, codec,
                                       fused=True if kernel == "qsync" else False)


# ---------------------------------------------------------------------------
# memory: no reference cycle keeps a step's tensors alive
# ---------------------------------------------------------------------------


def test_tree_map_frees_its_leaves_without_a_gc_pass():
    """``tree_map``'s input and output leaves die with their last
    reference, not at the next garbage-collector pass: a walker closure
    that called itself held them in a cycle, which kept every optimizer
    state of an LM GAN round alive until a collection and ran granite at
    full width out of the card's memory."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        y = tree_map(lambda t: t * 2, {"a": torch.zeros(8), "b": [torch.ones(3), None]})
        ref = weakref.ref(y["b"][0])
        del y
        assert ref() is None
    finally:
        gc.enable()


def test_lm_gan_step_leaves_no_tensor_in_a_reference_cycle():
    """A local step of the LM GAN (``vmap`` of the fused gradients, then
    the optimizers' updates) leaves no tensor behind in garbage cycles.
    The process's first step is taken and collected before: torch's
    first-call set-up leaves that step's input state in a cycle once."""
    import gc
    spec = train.arch_smoke_spec("granite-moe-3b-a800m", steps=1, K=1, seed=0,
                                 device="cpu", log_every=0)
    fed, data = spec.build(), spec.build_data()
    state = fed.init_state(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    strat = fed.cfg.resolve_strategy()
    state, _ = fed._step(state, data.sample_step(gen), strat)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        state, _ = fed._step(state, data.sample_step(gen), strat)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert leaked == []
