"""Shared set-up of the port's tests: the image experiment's nets at 8x8
in both packages, the forward-and-gradient parity check of a module
against its JAX twin, and one torch thread per test process (the tier-1
run puts several pytest workers on the same cores, where torch's default
of one thread per core oversubscribes them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import IntQuant as JQuant
from repro.core import FedGAN as JFedGAN, FedGANConfig as JConfig
from repro.core.strategies import FedAvgSync as JSync
from repro.launch.train import acgan_task as j_acgan_task
from repro.optim import SGD as JSGD, Adam as JAdam, constant as jconst, \
    equal_timescale as jequal

from repro_torch.comm import IntQuant
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import FedAvgSync, FedGAN, FedGANConfig, LocalOnly
from repro_torch.launch import train
from repro_torch.optim import SGD, Adam, constant, equal_timescale
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, GRID, BATCH, HW = 2, (1, 5), 8, 8
OPTS = {"sgd": (JSGD, SGD, 0.05), "adam": (JAdam, Adam, 1e-3)}


def _pair(opt, codec):
    return _strategy_pair(opt, JSync(codec=JQuant(8)) if codec else None,
                          FedAvgSync(codec=IntQuant(8)) if codec else None)


def _strategy_pair(opt, jstrategy, tstrategy, hw=HW, grid=GRID):
    """The same FedGAN in both packages, ACGAN nets at ``hw``, with the
    given sync strategies (None for the default)."""
    jopt, topt, lr = OPTS[opt]
    jtask, _ = j_acgan_task(hw=hw)
    ttask, _ = train.acgan_task(hw=hw)
    jfed = JFedGAN(jtask, JConfig(agent_grid=grid, sync_interval=K,
                                  strategy=jstrategy),
                   opt_g=jopt(), opt_d=jopt(), scales=jequal(jconst(lr)))
    tfed = FedGAN(ttask, FedGANConfig(agent_grid=grid, sync_interval=K,
                                      strategy=tstrategy),
                  opt_g=topt(), opt_d=topt(), scales=equal_timescale(constant(lr)))
    return jfed, tfed, lr


def coarsest_quanta(tfed, state, batches, qmax=127):
    """Per synced subtree, per leaf, the quantum of its coarsest block on
    either wire: max|v| / qmax over the agents' uplink values y = pre-sync
    params + EF residual (the same K steps without the sync, run by the
    port), with 1% for the float16 rounding of the scale."""
    local = dataclasses.replace(
        tfed, cfg=dataclasses.replace(tfed.cfg, strategy=LocalOnly()))
    pre, _ = local.round(state, batches)
    return {k: [1.01 * float((p + e).abs().max()) / qmax
                for p, e in zip(tree_leaves(pre["params"][k]), tree_leaves(e_tree))]
            for k, e_tree in state["ef"].items()}


def _batches(rng):
    lead = (K,) + GRID + (BATCH,)
    return {"x": rng.uniform(-1, 1, lead + (HW, HW, 3)).astype(np.float32),
            "y": rng.integers(0, 10, lead).astype(np.int32),
            "z": rng.standard_normal(lead + (62,)).astype(np.float32)}


ATOL = 1e-5


def _close(got, want, atol=ATOL, rtol=0.0):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=rtol)


def _assert_tree_close(got, want, atol=ATOL, rtol=0.0):
    got, want = to_jax_params(got), jax.device_get(want)
    jl, jt = jax.tree_util.tree_flatten(want)
    tl = jax.tree_util.tree_leaves(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        _close(t, j, atol=atol, rtol=rtol)


def _parity(jmod, tmod, inputs, *, seed=0):
    """Forward and gradient (of sum(out * r) wrt params and the float
    inputs) of a JAX module and its port on the same weights."""
    jparams = jmod.init(jax.random.key(seed))
    tparams = from_jax_params(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(seed + 1)
    jout = jax.jit(jmod.apply)(jparams, *[jnp.asarray(x) for x in inputs])
    touts = tmod.apply(tparams, *[torch.from_numpy(x) for x in inputs])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = touts if isinstance(touts, tuple) else (touts,)
    for t, j in zip(touts, jouts):
        _close(t.numpy(), j)
    rs = [rng.standard_normal(np.shape(j)).astype(np.float32) for j in jouts]

    def jloss(p, x0):
        o = jmod.apply(p, x0, *[jnp.asarray(x) for x in inputs[1:]])
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * r) for a, r in zip(o, rs))

    def tloss(p, x0):
        o = tmod.apply(p, x0, *[torch.from_numpy(x) for x in inputs[1:]])
        o = o if isinstance(o, tuple) else (o,)
        return sum(torch.sum(a * torch.from_numpy(r)) for a, r in zip(o, rs))

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jparams, jnp.asarray(inputs[0]))
    tg_p, tg_x = torch.func.grad(tloss, argnums=(0, 1))(
        tparams, torch.from_numpy(inputs[0]))
    _assert_tree_close(tg_p, jg_p)
    _close(tg_x.numpy(), jg_x)
