"""The fused Adam step with the uplink quantize (``adam_sync_flat`` /
``adam_sync_tree``) on the CPU: the port's plain version against the JAX
reference, and against the port's own ``Adam.update`` + ``quantize_blocks``.

Tolerances, with their reasons:

* Against the reference, mu' and nu' within 4 float32 ulps, and p'
  within 4 ulps of the larger operand of its last operation, p - step.
  The reference is jitted on XLA:CPU, which contracts ``b * m + (1 - b) *
  g`` into fused multiply-adds and computes the bias corrections with its
  own ``pow``; the port rounds every operation on its own, as eager
  PyTorch does.  So the step may differ in its last ulp, and where p and
  the step nearly cancel that ulp is many ulps of the small p' (a
  property example at lr 0.1 measured 32 ulps of p', under 1 ulp of the
  step).
* Scales bit for bit (the f16 rounding of a block's max-abs absorbs an ulp
  of p').  Codes at most 1 apart, and only where the reference's p'/s lies
  within 1e-4 of a .5 tie, where one ulp of p' decides the rounding.
* The port's quantize of the reference's p' gives the reference's codes
  and scales bit for bit, and ``adam_sync_tree`` equals ``Adam.update``
  followed by ``quantize_blocks`` of the bucketed params bit for bit (the
  same operations in the same order on the same device).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from torch_shared import one_torch_thread  # noqa: F401

from repro.kernels.qsync import ops as jops

from repro_torch.kernels.qpack.ops import quantize_blocks
from repro_torch.kernels.qpack.ref import quant_blocks_ref
from repro_torch.kernels.qsync import kernel as tkernel, ops as tops
from repro_torch.optim import Adam


def _inputs(B, n, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((B, n)).astype(np.float32)
    g = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    mu = (0.05 * rng.standard_normal((B, n))).astype(np.float32)
    nu = (0.01 * rng.random((B, n))).astype(np.float32)
    return p, g, mu, nu


def _ulps(a, b):
    """Distance in float32 ulps (the integers of the ordered bit patterns)."""
    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def _near_tie(p, scales, block):
    """Where p / s lies within 1e-4 of a .5 tie (s the decode scale of the
    element's block)."""
    s = scales.astype(np.float32)
    s = np.where(s > 0, s, np.float32(1.0))
    r = p / np.repeat(s, block, axis=1)[:, :p.shape[1]]
    return np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-4


def _check_against_jax(want, got, p, n, block=128):
    """``p`` the params before the step."""
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    for i in range(3):
        assert got[i].shape == want[i].shape
    for i in (1, 2):   # the moments
        assert _ulps(got[i], want[i]).max() <= 4
    # p' = p - step: ulps at the larger of |p| and |step| = |p - p'|
    scale = np.maximum(np.abs(p), np.abs(p - want[0])).astype(np.float32)
    assert np.all(np.abs(got[0] - want[0]) <= 4 * np.spacing(scale))
    assert got[3].dtype == np.int8 and got[4].dtype == np.float16
    np.testing.assert_array_equal(got[4].view(np.uint16), want[4].view(np.uint16))
    diff = np.abs(got[3].astype(np.int32) - want[3].astype(np.int32))
    assert diff.max() <= 1
    pw = np.pad(want[0], ((0, 0), (0, got[3].shape[1] - n)))
    assert np.all(_near_tie(pw, want[4], block)[diff > 0])


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["jnp-ref", "pallas-interpret"])
@pytest.mark.parametrize("count", [0, 7])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 5])
def test_adam_sync_plain_matches_jax(B, bits, count, jax_kernel):
    """``ops.adam_sync_flat`` (pad to the block multiple, the plain
    version, trim; n = 300 is not a block multiple) against the
    reference's jitted oracle and its Pallas kernel in interpret mode."""
    n = 300
    arrs = _inputs(B, n, seed=100 * B + 10 * bits + count)
    want = jops.adam_sync_flat(*map(jnp.asarray, arrs), lr=0.01,
                               count=jnp.int32(count), bits=bits,
                               use_kernel=jax_kernel)
    got = tops.adam_sync_flat(*map(torch.from_numpy, arrs), lr=0.01,
                              count=torch.tensor(count, dtype=torch.int32), bits=bits)
    assert got[3].shape == (B, 384) and got[4].shape == (B, 3)
    _check_against_jax(want, got, arrs[0], n)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 700), B=st.integers(1, 4), bits=st.sampled_from([4, 8]),
       count=st.integers(0, 50), lr=st.sampled_from([1e-3, 2e-4, 0.1]),
       seed=st.integers(0, 99))
@example(n=154, B=3, bits=4, count=6, lr=0.1, seed=0)   # p and the step nearly cancel
def test_adam_sync_plain_matches_jax_property(n, B, bits, count, lr, seed):
    arrs = _inputs(B, n, seed)
    want = jops.adam_sync_flat(*map(jnp.asarray, arrs), lr=lr,
                               count=jnp.int32(count), bits=bits, use_kernel=False)
    got = tops.adam_sync_flat(*map(torch.from_numpy, arrs), lr=lr,
                              count=torch.tensor(count, dtype=torch.int32), bits=bits)
    _check_against_jax(want, got, arrs[0], n)


@pytest.mark.parametrize("bits", [4, 8])
def test_port_quantize_of_jax_params_gives_jax_codes(bits):
    """Given the reference's p', the port's block quantize reproduces the
    reference's codes and scales bit for bit: any code difference above
    comes from p', not from the quantizer."""
    arrs = _inputs(5, 1000, seed=bits)
    want = [np.asarray(x) for x in jops.adam_sync_flat(
        *map(jnp.asarray, arrs), lr=0.01, count=jnp.int32(3), bits=bits,
        use_kernel=False)]
    p = torch.from_numpy(np.pad(want[0], ((0, 0), (0, 24))))
    q, s = quant_blocks_ref(p, qmax=2 ** (bits - 1) - 1, block=128)
    np.testing.assert_array_equal(q.numpy(), want[3])
    np.testing.assert_array_equal(s.numpy().view(np.uint16), want[4].view(np.uint16))


@pytest.mark.parametrize("count", [0, 4])
@pytest.mark.parametrize("bits", [4, 8])
def test_adam_sync_tree_matches_adam_update_then_quantize(bits, count):
    """The tree entry point equals the port's ``Adam.update`` followed by
    ``quantize_blocks`` of the bucketed new params, bit for bit, and steps
    the count by one.  Leaves of several shapes, one 0-d per agent."""
    g = torch.Generator().manual_seed(bits + count)
    B = 5
    params = {"wa": torch.randn((B, 33), generator=g),
              "wb": torch.randn((B, 4, 128), generator=g),
              "theta": torch.randn((B,), generator=g)}
    grads = {k: 0.1 * v + 0.03 for k, v in params.items()}
    state = {"count": torch.tensor(count, dtype=torch.int32),
             "mu": {k: 0.2 * v for k, v in params.items()},
             "nu": {k: 0.1 * v.abs() for k, v in params.items()}}
    adam = Adam(b1=0.5, b2=0.999)
    p_ref, s_ref = adam.update(params, grads, state, 0.01)
    launches = tkernel.adam_sync_flat.launches
    p2, s2, q, s = tops.adam_sync_tree(params, grads, state, lr=0.01, bits=bits)
    assert tkernel.adam_sync_flat.launches == launches   # the plain version
    for k in params:
        assert p2[k].shape == params[k].shape
        assert torch.equal(p2[k], p_ref[k])
        assert torch.equal(s2["mu"][k], s_ref["mu"][k])
        assert torch.equal(s2["nu"][k], s_ref["nu"][k])
    assert int(s2["count"]) == int(s_ref["count"]) == count + 1
    buf = tops._bucket([p2[k] for k in sorted(p2)], B, 128)[0]
    assert buf.shape == (B, 128 + 512 + 128)
    q_ref, s_ref = quant_blocks_ref(buf, qmax=2 ** (bits - 1) - 1, block=128)
    assert torch.equal(q, q_ref) and torch.equal(s.view(torch.int16),
                                                 s_ref.view(torch.int16))
    if bits == 8:   # the codec's entry point packs int4, so compare at int8
        payload, scales = quantize_blocks(buf, bits=8)
        assert torch.equal(q, payload) and torch.equal(s, scales)


def test_adam_sync_padding_lanes_stay_zero():
    """Zero p, g, mu and nu take the step 0 / (0 + eps) = 0: the padded
    lanes of the bucket stay 0 and move no block's max-abs."""
    z = torch.zeros((2, 128))
    hyper = torch.tensor([[0.01, 0.5, 0.001]])
    p, mu, nu, q, s = tkernel.adam_sync_flat(hyper, z, z, z, z, b1=0.5, b2=0.999,
                                             eps=1e-8, qmax=127)
    assert not p.any() and not mu.any() and not nu.any() and not q.any()
    assert not s.float().any()


def test_adam_sync_wrapper_refusals():
    """The wrapper refuses what the kernel does not take: non-float32
    inputs, tensors on mixed devices (anything not all on the CPU goes to
    the kernel's checks), shapes that disagree, N off the block multiple."""
    x = torch.zeros((5, 256))
    hyper = torch.tensor([[0.01, 0.5, 0.001]])
    kw = dict(b1=0.5, b2=0.999, eps=1e-8, qmax=127)
    with pytest.raises(TypeError, match="float32"):
        tkernel.adam_sync_flat(hyper, x.double(), x, x, x, **kw)
    with pytest.raises(TypeError, match="float32"):
        tkernel.adam_sync_flat(hyper.half(), x, x, x, x, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.adam_sync_flat(hyper, x, x.to("meta"), x, x, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.adam_sync_flat(hyper.to("meta"), *(x.to("meta"),) * 4, **kw)
    with pytest.raises(ValueError, match="mu must be"):
        tkernel.adam_sync_flat(hyper, x, x, x[:, :128], x, **kw)
    with pytest.raises(ValueError, match="multiple of block"):
        tkernel.adam_sync_flat(hyper, *(x[:, :200],) * 4, **kw)
    with pytest.raises(ValueError, match="hyper"):
        tkernel.adam_sync_flat(hyper[:, :2], x, x, x, x, **kw)
    with pytest.raises(ValueError, match="bits"):
        tops.adam_sync_flat(x, x, x, x, lr=0.01, count=torch.tensor(0), bits=6)
