"""The port's FedGAN round against the JAX reference, on the CPU, at
ACGAN width with 8x8 images, B = 5 agents, K = 2, batch 8.

Round parity is checked one round at a time, each from the same state on
both sides (round 1 from the reference's init, round 2 from the
reference's round-1 state, EF residuals included), because the GAN's
trajectory amplifies any difference: a ReLU whose pre-activation sits at
float-noise distance from zero flips, and a few steps later the two runs
disagree at the size of a learning-rate step.  Tolerances, with reasons:

* SGD, plain sync: 1e-5 of each leaf's magnitude; float32 roundoff of two
  steps through the library convolutions, then the eq. (2) reduce.
* Adam, plain sync: 2·K·lr.  Adam scales every element's step to about lr
  whatever its gradient's size, so an element whose gradient is float
  noise (a bias feeding a batch norm has a true gradient of zero) takes a
  ±lr step with the noise's sign, which the two packages need not share.
* int8 sync: the above plus one quantum of the leaf's coarsest block, on
  at most 2% of the elements: a value within roundoff of a rounding tie
  may take the neighbouring code, and its EF residual then differs by one
  quantum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_shared import (GRID, K, _batches, _pair, assert_round_close,  # noqa: F401
                          one_torch_thread)

from repro_torch.convert import from_jax_params


@pytest.mark.parametrize("codec", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_round_matches_jax(opt, codec):
    jfed, tfed, lr = _pair(opt, codec)
    rng = np.random.default_rng(0)
    jstate = jfed.init_state(jax.random.key(0))
    jround = jax.jit(jfed.round)
    seeds = jnp.zeros((K,) + GRID, jnp.uint32)
    for r in range(2):
        batches = _batches(rng)
        start = from_jax_params(jax.device_get(jstate), device="cpu")
        tbatches = from_jax_params(batches, device="cpu")
        tstate, tm = tfed.round(start, tbatches)
        jstate, jm = jround(jstate, jax.tree_util.tree_map(jnp.asarray, batches),
                            seeds)
        # the first step's losses come from the same weights and batch
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(tm[k][0].item(), float(jm[k][0]), rtol=1e-6)
        want = jax.device_get(jstate)
        assert int(want["step"]) == (r + 1) * K
        assert_round_close(tfed, start, tbatches, tstate, want, opt, lr, codec)
