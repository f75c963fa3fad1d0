"""The port's kernels on the CPU: their plain versions and wrappers
against the JAX reference (the CUDA kernels against the plain versions on
the card are in ``test_torch_cuda.py``).

Tolerances, with their reasons:

* fedavg, float32: within 1e-6 of sum_b |w_b x_bn|.  The reduce of B
  products in another order moves the sum by at most (B - 1) float32
  roundings of that magnitude (about 5e-7 at B = 5).  bfloat16 outputs may
  then round to a neighbouring bfloat16, so they get one bfloat16 ulp
  (at most 2^-7 relative) on top.
* qsync: ``new_ef`` is elementwise (EF add, quantize, dequantize) and must
  be bit-identical.  ``synced`` and ``new_ef_down`` follow the reduce over
  agents: at grid (1, 2) a two-term sum has one order, so everything is
  bit-identical; at (1, 5) and (2, 3) a different summation order may move
  a code across a rounding boundary (or the block's max-abs, and with it
  the scale), so they get one quantum of their block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_torch_thread  # noqa: F401

from repro.dist import collectives as jcoll
from repro.kernels.fedavg.ops import fedavg_tree
from repro.kernels.fedavg.ref import fedavg_flat_ref as jfedavg_ref
from repro.kernels.qsync import ops as jqsync

from repro_torch.dist import collectives as tcoll
from repro_torch.kernels.fedavg.kernel import fedavg_flat
from repro_torch.kernels.fedavg.ref import fedavg_flat_ref
from repro_torch.kernels.qsync import kernel as tqkernel, ops as tqsync
from repro_torch.kernels.qsync.ref import _wire_scale


def _weights(grid, rng):
    w = rng.random(grid).astype(np.float32) + 0.1
    return w / w.sum()


def _fedavg_bound(w, x):
    """1e-6 of sum_b |w_b x_bn| per column."""
    return 1e-6 * np.abs(w.reshape(-1, 1).astype(np.float32) * x).sum(0)


def _bf16(x):
    """float32 values exactly representable in bfloat16."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# fedavg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(5,), (1, 5), (2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_plain_matches_jax(grid, dtype):
    """The port's plain version against the Pallas kernel (interpret mode)
    and the reference's jnp oracle."""
    rng = np.random.default_rng(0)
    B, N = int(np.prod(grid)), 1000
    w = _weights(grid, rng)
    x = rng.standard_normal((B, N)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fedavg_flat(torch.from_numpy(w), tx).float().numpy()
    bound = _fedavg_bound(w, x)
    if dtype == "bfloat16":
        bound = bound + np.abs(got) * 2.0 ** -7
    for want in (fedavg_tree(jnp.asarray(w), {"x": jx}, interpret=True)["x"],
                 jfedavg_ref(jnp.asarray(w).reshape(-1), jx)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()
    np.testing.assert_array_equal(
        got, fedavg_flat_ref(torch.from_numpy(w), tx).float().numpy())


def test_average_agents_buckets_and_matches_jax():
    """The port's sync reduce (bucketed, one launch per dtype group)
    against the reference's per-leaf ``weighted_mean``; integer leaves
    pass through."""
    rng = np.random.default_rng(1)
    grid = (1, 5)
    w = _weights(grid, rng)
    tree = {"a": rng.standard_normal(grid + (3, 4)).astype(np.float32),
            "b": rng.standard_normal(grid + (7,)).astype(np.float32),
            "count": np.full(grid, 3, np.int32)}
    want = jcoll.average_agents(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(w))
    got = tcoll.average_agents({k: torch.from_numpy(v) for k, v in tree.items()},
                               torch.from_numpy(w))
    for k in ("a", "b"):
        bound = _fedavg_bound(w, tree[k].reshape(5, -1)).reshape(tree[k].shape[2:])
        assert np.all(np.abs(got[k].numpy() - np.asarray(want[k])) <= bound)
    np.testing.assert_array_equal(got["count"].numpy(), tree["count"])


def test_fedavg_wrapper_refuses_non_cpu_tensors_it_cannot_launch():
    """Only CPU tensors take the plain version; anything else goes to the
    kernel's checks and is refused there, never silently computed."""
    w = torch.full((5,), 0.2)
    with pytest.raises(ValueError, match="CUDA device"):
        fedavg_flat(w.to("meta"), torch.empty((5, 8), device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        fedavg_flat(w, torch.empty((5, 8), device="meta"))
    with pytest.raises(ValueError, match=r"\(5, N\)"):
        fedavg_flat(w, torch.zeros((4, 8)))
    before = fedavg_flat.launches
    fedavg_flat(w, torch.zeros((5, 8)))
    assert fedavg_flat.launches == before   # the plain version is no launch


# ---------------------------------------------------------------------------
# qsync
# ---------------------------------------------------------------------------


def _qsync_inputs(grid, ef, n, seed):
    rng = np.random.default_rng(seed)
    B = int(np.prod(grid))
    w = _weights(grid, rng)
    # mixed magnitudes so blocks get different scales, plus one all-zero
    # block (scale 0 -> divisor 1)
    x = (rng.standard_normal((B, n)) * rng.choice([1e-3, 1.0, 30.0], (B, n))
         ).astype(np.float32)
    x[:, :128] = 0.0
    e = (0.01 * rng.standard_normal((B, n))).astype(np.float32) if ef else None
    ed = (0.01 * rng.standard_normal(n)).astype(np.float32) if ef else None
    return w, x, e, ed


def _as(fn, arrs):
    return [None if a is None else fn(a) for a in arrs]


def _quantum(y, qmax, block):
    """Per-element quantum (the divisor s of its block) of the stream y."""
    n = y.shape[-1]
    pad = (-n) % block
    yp = np.pad(y, (0, pad)).reshape(-1, block)
    _, s = _wire_scale(torch.from_numpy(np.abs(yp).max(-1, keepdims=True)), qmax)
    return np.repeat(s.numpy()[:, 0], block)[:n]


@pytest.mark.parametrize("grid", [(1, 2), (1, 5), (2, 3)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("jax_kernel", [False, True], ids=["jnp-ref", "pallas-interpret"])
def test_qsync_plain_matches_jax(grid, bits, ef, jax_kernel):
    """The port's plain version (through ``ops.qsync_flat``: pad to the
    block multiple, sync, trim; N = 1000 is not a block multiple) against
    the reference's jnp oracle and its Pallas kernel in interpret mode."""
    w, x, e, ed = _qsync_inputs(grid, ef, 1000, seed=bits + 10 * ef)
    qmax = 2 ** (bits - 1) - 1
    want = jqsync.qsync_flat(*_as(jnp.asarray, (w, x, e, ed)), bits=bits,
                             use_kernel=jax_kernel)
    got = tqsync.qsync_flat(*_as(torch.from_numpy, (w, x, e, ed)), bits=bits)
    want = [None if a is None else np.asarray(a) for a in want]
    got = [None if a is None else a.numpy() for a in got]
    assert (got[1] is None) == (not ef) and (got[2] is None) == (not ef)
    if ef:
        np.testing.assert_array_equal(got[1], want[1])
    yd = want[0] + (want[2] if ef else 0.0)
    if int(np.prod(grid)) != 2:
        q = _quantum(yd, qmax, 128)
        for i in (0, 2):
            if got[i] is not None:
                assert np.all(np.abs(got[i] - want[i]) <= q)
        return
    np.testing.assert_array_equal(got[0], want[0])
    if not ef:
        return
    if jax_kernel:
        # XLA:CPU contracts the products and the ed add into fused
        # multiply-adds inside the interpret-mode kernel (the reference's own
        # known gap between its kernel and its oracle): yd, and so
        # yd - synced, may move by a float32 rounding of the summed terms
        terms = np.abs(w.reshape(-1, 1) * (x + e)).sum(0) + np.abs(ed)
        assert np.all(np.abs(got[2] - want[2]) <= 2 * np.spacing(terms))
    else:
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("bits", [4, 8])
def test_qsync_leaves_bucketing_matches_per_leaf(bits):
    """One bucketed launch per subtree equals one sync per leaf, bit for
    bit: each leaf is padded to its own block multiple before the
    concatenation, so the quantizer sees the same tiles."""
    rng = np.random.default_rng(bits)
    grid = (1, 5)
    w = torch.from_numpy(_weights(grid, rng))
    shapes = [(3, 50), (129,), (4, 4, 2, 8), (1,)]
    leaves = [torch.from_numpy(rng.standard_normal(grid + s).astype(np.float32))
              for s in shapes]
    efs = [0.01 * torch.randn_like(x) for x in leaves]
    eds = [0.01 * torch.randn(x.shape[2:]) for x in leaves]
    outs, ne, ned = tqsync.qsync_leaves(leaves, w, efs, eds, bits=bits)
    for x, e, ed, o, a, b in zip(leaves, efs, eds, outs, ne, ned):
        s, e2, ed2 = tqsync.qsync_flat(w, x.reshape(5, -1), e.reshape(5, -1),
                                       ed.reshape(-1), bits=bits)
        assert o.shape == x.shape and torch.equal(o[0, 3], s.reshape(x.shape[2:]))
        assert torch.equal(o[0, 0], o[0, 4])
        assert torch.equal(a, e2.reshape(x.shape))
        assert torch.equal(b, ed2.reshape(x.shape[2:]))
    # and the reference's own bucketing agrees with the port's
    jo, jne, jned = jqsync.qsync_leaves(
        [jnp.asarray(x.numpy()) for x in leaves], jnp.asarray(w.numpy()),
        [jnp.asarray(e.numpy()) for e in efs], [jnp.asarray(e.numpy()) for e in eds],
        bits=bits, use_kernel=False)
    for got, want in zip(ne, jne):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qsync_wrapper_checks():
    w = torch.full((1, 5), 0.2)
    x = torch.zeros((5, 256))
    with pytest.raises(ValueError, match="multiple of block"):
        tqkernel.qsync_flat(w, x[:, :200], qmax=127)
    with pytest.raises(ValueError, match="CUDA device"):
        tqkernel.qsync_flat(w.to("meta"), x.to("meta"), qmax=127)
    with pytest.raises(ValueError, match="bits"):
        tqsync.qsync_flat(w, x, bits=6)
    before = tqkernel.qsync_flat.launches
    tqkernel.qsync_flat(w, x, qmax=127)
    assert tqkernel.qsync_flat.launches == before
