"""Parity of the port's layers, ACGAN nets, losses and optimizers with the
JAX reference, on the CPU.

The same weights (initialised by the reference, carried over with
``repro_torch.convert``) and the same inputs (numpy, fixed seeds) go
through both packages.  Forward values and gradients agree to ``atol
1e-5`` scaled by the leaf's largest magnitude when that exceeds 1: both
sides compute in float32 and differ only in the summation order inside
the library convolutions and matrix products, whose rounding grows with
the size of the sums (a weight gradient of the transpose conv sums
batch x pixels products of magnitude ~1).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import (_assert_tree_close, _close, _parity,  # noqa: F401
                          one_torch_thread)

from repro import nn as jnn
from repro.core import losses as jlosses
from repro.models import gan_nets as jnets
from repro import optim as joptim
from repro.optim import SGD as JSGD, Adam as JAdam, AdamW as JAdamW

from repro_torch import nn as tnn
from repro_torch.convert import from_jax_params
from repro_torch.core import losses as tlosses
from repro_torch.models import gan_nets as tnets
from repro_torch import optim as toptim
from repro_torch.optim import SGD as TSGD, Adam as TAdam, AdamW as TAdamW

def test_dense_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 7)).astype(np.float32)
    _parity(jnn.Dense(7, 5), tnn.Dense(7, 5), [x])


@pytest.mark.parametrize("hw", [4, 8, 7])
def test_conv2d_same_stride2_matches_jax(hw):
    """k=4, s=2, SAME: 1 pixel of padding on each side for even H, and
    XLA's uneven split (1 low, 2 high) for odd H."""
    x = np.random.default_rng(1).standard_normal((2, hw, hw, 3)).astype(np.float32)
    _parity(jnn.Conv2D(3, 5), tnn.Conv2D(3, 5), [x])


@pytest.mark.parametrize("hw", [2, 4])
def test_conv_transpose2d_matches_jax(hw):
    """jax.lax.conv_transpose does not flip the kernel; F.conv_transpose2d
    does.  Without the port's flip this is off by about 13."""
    x = np.random.default_rng(2).standard_normal((2, hw, hw, 3)).astype(np.float32)
    _parity(jnn.ConvTranspose2D(3, 5), tnn.ConvTranspose2D(3, 5), [x])


@pytest.mark.parametrize("shape", [(16, 6), (4, 3, 3, 5)])
def test_batchnorm_matches_jax(shape):
    x = (3.0 + 2.0 * np.random.default_rng(3).standard_normal(shape)).astype(np.float32)
    _parity(jnn.BatchNorm(shape[-1]), tnn.BatchNorm(shape[-1]), [x])


def test_acgan_generator_matches_jax():
    rng = np.random.default_rng(4)
    z = rng.standard_normal((6, 62)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int64)
    _parity(jnets.ACGANGenerator(image_hw=8), tnets.ACGANGenerator(image_hw=8),
            [z, y])


def test_acgan_discriminator_matches_jax():
    img = np.random.default_rng(5).uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)
    _parity(jnets.ACGANDiscriminator(image_hw=8),
            tnets.ACGANDiscriminator(image_hw=8), [img])


def test_acgan_losses_match_jax():
    rng = np.random.default_rng(6)
    rb, fb = (rng.standard_normal(8).astype(np.float32) * 30 for _ in range(2))
    rc, fc = (rng.standard_normal((8, 10)).astype(np.float32) for _ in range(2))
    y = rng.integers(0, 10, 8)
    j = jlosses.acgan_d_loss(*map(jnp.asarray, (rb, fb, rc, fc, y)))
    t = tlosses.acgan_d_loss(*map(torch.from_numpy, (rb, fb, rc, fc, y)))
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-6)
    j = jlosses.acgan_g_loss(*map(jnp.asarray, (fb, fc, y)))
    t = tlosses.acgan_g_loss(*map(torch.from_numpy, (fb, fc, y)))
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-6)


@pytest.mark.parametrize("make", [
    pytest.param(lambda m: m.Adam(), id="adam"),
    pytest.param(lambda m: m.Adam(b1=0.9, b2=0.99, eps=1e-6), id="adam-knobs"),
    pytest.param(lambda m: m.SGD(), id="sgd"),
    pytest.param(lambda m: m.SGD(momentum=0.9), id="sgd-momentum"),
    pytest.param(lambda m: m.AdamW(weight_decay=0.1), id="adamw"),
])
def test_optimizer_matches_jitted_jax(make):
    """Three updates of the port against ``jax.jit(opt.update)``, the form
    the reference trainer runs.  Adam's bias corrections (pow in float32)
    and XLA's fused multiply-adds may move the last bit, so the bound is a
    few float32 ulps of the parameters (rtol 1e-6)."""
    jopt = make(types.SimpleNamespace(Adam=JAdam, SGD=JSGD, AdamW=JAdamW))
    topt = make(types.SimpleNamespace(Adam=TAdam, SGD=TSGD, AdamW=TAdamW))
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), from_jax_params(params, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jupd = jax.jit(jopt.update)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        lr = np.float32(1e-2 * (i + 1))
        jp, js = jupd(jp, jax.tree_util.tree_map(jnp.asarray, g), js, lr)
        tp, ts = topt.update(tp, from_jax_params(g, device="cpu"), ts, torch.tensor(lr))
    _assert_tree_close(tp, jp, atol=0.0, rtol=1e-6)
    _assert_tree_close(ts, js, atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 0.01, 10.0], ids=["zero", "under", "over"])
def test_clip_by_global_norm_matches_jax(scale):
    """Clipping above the bound, passing below it, and the zero-norm guard
    (an all-zero tree passes through with scale 1)."""
    rng = np.random.default_rng(8)
    grads = {"a": scale * rng.standard_normal((4, 3)).astype(np.float32),
             "b": scale * rng.standard_normal(5).astype(np.float32)}
    jg, jn = joptim.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), 1.0)
    tg, tn = toptim.clip_by_global_norm(from_jax_params(grads, device="cpu"), 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    _assert_tree_close(tg, jg, atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("make", [
    pytest.param(lambda m: m.equal_timescale(m.constant(1e-3)), id="constant"),
    pytest.param(lambda m: m.equal_timescale(m.power_decay(0.1, tau=50.0, p=0.6)),
                 id="power-decay"),
    pytest.param(lambda m: m.constant_ttur(2e-4, 1e-4), id="ttur"),
])
def test_schedules_match_jax(make):
    js, ts = make(joptim), make(toptim)
    assert js.equal == ts.equal
    for n in (0.0, 1.0, 37.0, 1000.0):
        tn = torch.tensor(n, dtype=torch.float32)
        for j, t in ((js.a, ts.a), (js.b, ts.b)):
            np.testing.assert_allclose(t(tn).item(), float(j(jnp.float32(n))),
                                       rtol=1e-6)
    with pytest.raises(ValueError, match="A2"):
        toptim.power_decay(0.1, p=0.5)
