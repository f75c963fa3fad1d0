"""The port's collectives and the fedavg kernel's routes against the JAX
reference, on the CPU, bit for bit.

* ``average_agents`` computes the reference's ``weighted_mean`` in the
  leaf's own type.  On a bfloat16 or float16 leaf (a ``sync_dtype`` wire)
  that is the wire route: weights and products rounded to the type, the
  sum in float32 in agent order.  Every element must be equal.  Float32
  leaves keep the float32 route, whose plain version (``fedavg_flat_ref``)
  sums the rounded products from +0 in agent order, as the reference's
  ``weighted_mean`` does op by op; held within 1e-6 of sum_b |w_b x_b|
  to the reference's compiled reduce, which groups otherwise, the bound
  ``test_torch_kernels.py`` holds it to.
* ``average_intra_pod`` is the reference's einsum, which on XLA's CPU
  backend is a fused multiply-add chain in agent order: the pod route.
  Every element must be equal, with one exception of the reference's own:
  for P >= 3 pods of A >= 3 agents and N = 1 (mod 16) columns, XLA's dot
  computes the last column unfused (products rounded, then summed in
  order).  That column is checked to be exactly that, and the pod route's
  value there to lie within A float32 roundings of sum_a |w_a x_a|.  On a
  bfloat16 or float16 leaf the einsum runs in that type: the weights
  rounded to it, the same chain in float32, one rounding at the end; every
  element equal, with no exception.
* ``fedavg_tree`` keeps the Pallas kernel's float32 products: it is held
  to the JAX ``fedavg_tree`` in interpret mode within 1e-6 of
  sum_b |w_b x_b| (the reduce order differs), and bit for bit to the
  port's own plain ``fedavg_tree_ref``.
"""
import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_torch_thread  # noqa: F401

from repro.dist import collectives as jcoll
from repro.kernels.fedavg.ops import fedavg_tree as jfedavg_tree

from repro_torch.dist import collectives as tcoll
from repro_torch.kernels.fedavg import ref as tref
from repro_torch.kernels.fedavg.ops import fedavg_tree

_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16),
           "float32": (jnp.float32, torch.float32)}


def _weights(grid, rng):
    w = rng.random(grid).astype(np.float32) + 0.1
    return w / w.sum()


def _bits(x):
    """The raw bits of a numpy or torch array, as int64 (so -0 != +0)."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def _as(jtype, ttype, x):
    """``x`` (float32 numpy) rounded to the type, in both packages."""
    jx = jnp.asarray(x).astype(jtype)
    return jx, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(ttype)


def _assert_mean_equal(got, want, w, x):
    """Bit for bit in bfloat16 and float16; in float32 within 1e-6 of
    sum_b |w_b x_b| (the float32 route's own bound)."""
    want = want.astype(jnp.float32)
    if got.dtype != torch.float32:
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    B = w.size
    mag = np.abs(w.reshape(-1, 1) * x.float().numpy().reshape(B, -1)).sum(0)
    diff = np.abs(got.numpy() - np.asarray(want)).reshape(B, -1)
    assert np.all(diff <= 1e-6 * mag), float(diff.max())


def test_bf16_average_matches_the_reference_on_the_reported_leaf():
    """One bfloat16 leaf (1, 5, 4096), seed 0, weights 0.1 to 0.3: float32
    weights and products (the ``fedavg_bf16`` entry, which this average
    took before the wire route) disagree with the reference on 1,936 of
    the 4,096 means; the wire route on none."""
    rng = np.random.default_rng(0)
    w = np.array([[0.1, 0.15, 0.2, 0.25, 0.3]], np.float32)
    jx, tx = _as(jnp.bfloat16, torch.bfloat16,
                 rng.standard_normal((1, 5, 4096)).astype(np.float32))
    want = jcoll.average_agents({"x": jx}, jnp.asarray(w))["x"]
    got = tcoll.average_agents({"x": tx}, torch.from_numpy(w))["x"]
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    np.testing.assert_array_equal(_bits(got), _bits(want.astype(jnp.float32)))
    f32_products = tref.fedavg_flat_ref(torch.from_numpy(w), tx.reshape(5, -1))
    assert int((_bits(f32_products) != _bits(want[0, 0].astype(jnp.float32))).sum()) > 1000


@pytest.mark.parametrize("grid", [(1, 5), (2, 4), (1, 16), (1, 8)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_average_agents_matches_the_reference(grid, dtype):
    """Leaves stored in ``dtype`` (N = 1,027 and (3, 7, 5)), an int32 leaf
    passing through, non-uniform weights."""
    rng = np.random.default_rng(sum(grid))
    w = _weights(grid, rng)
    jt, tt = _DTYPES[dtype]
    shapes = {"a": (1027,), "b": (3, 7, 5)}
    jtree, ttree = {}, {}
    for k, s in shapes.items():
        x = (rng.standard_normal(grid + s) * rng.choice([1e-3, 1.0, 30.0], grid + s))
        jtree[k], ttree[k] = _as(jt, tt, x.astype(np.float32))
    n = rng.integers(0, 9, grid).astype(np.int32)
    jtree["n"], ttree["n"] = jnp.asarray(n), torch.from_numpy(n)
    want = jcoll.average_agents(jtree, jnp.asarray(w))
    got = tcoll.average_agents(ttree, torch.from_numpy(w))
    for k in shapes:
        assert got[k].dtype == tt and got[k].shape == ttree[k].shape
        _assert_mean_equal(got[k], want[k], w, ttree[k])
    assert got["n"] is ttree["n"]


@pytest.mark.parametrize("sync", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("grid", [(1, 5), (2, 4)])
def test_sync_dtype_average_matches_the_reference(grid, sync):
    """Float32 leaves cast to the wire type for the reduce and back: the
    reference's ``average_agents(sync_dtype=)``."""
    rng = np.random.default_rng(7)
    w = _weights(grid, rng)
    tree = {"a": rng.standard_normal(grid + (2051,)).astype(np.float32),
            "b": (30 * rng.standard_normal(grid + (4, 9))).astype(np.float32),
            "n": np.full(grid, 3, np.int32)}
    want = jcoll.average_agents(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w),
                                sync_dtype=_DTYPES[sync][0])
    got = tcoll.average_agents({k: torch.from_numpy(v) for k, v in tree.items()},
                               torch.from_numpy(w), sync_dtype=_DTYPES[sync][1])
    for k in ("a", "b"):
        assert got[k].dtype == torch.float32
        if sync == "float32":
            _assert_mean_equal(got[k], want[k], w, torch.from_numpy(tree[k]))
        else:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    np.testing.assert_array_equal(got["n"].numpy(), tree["n"])


def test_sync_bytes_match_the_reference():
    tree = {"a": np.zeros((3, 50), np.float32), "n": np.zeros((2,), np.int32),
            "h": np.zeros((7,), np.float16)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for jt, tt in [(None, None)] + [v[:2] for v in _DTYPES.values()]:
        assert tcoll.sync_bytes(ttree, sync_dtype=tt) == jcoll.sync_bytes(tree, sync_dtype=jt)
    from repro_torch.comm import IntQuant
    with pytest.raises(ValueError, match="both wire compressions"):
        tcoll.sync_bytes(ttree, sync_dtype=torch.bfloat16, codec=IntQuant(8))


def _pod_case(grid, shape, seed):
    rng = np.random.default_rng(seed)
    w = _weights(grid, rng)
    x = (rng.standard_normal(grid + shape)
         * rng.choice([1e-3, 1.0, 30.0], grid + shape)).astype(np.float32)
    want = np.asarray(jcoll.average_intra_pod({"x": jnp.asarray(x)}, jnp.asarray(w))["x"])
    got = tcoll.average_intra_pod({"x": torch.from_numpy(x)}, torch.from_numpy(w))["x"]
    return w, x, want, got.numpy()


@pytest.mark.parametrize("grid,shape", [((2, 4), (4099,)), ((2, 2), (1000,)),
                                        ((4, 3), (512,)), ((2, 4), (3, 3, 7)),
                                        ((3, 5), (16,)), ((2, 3), (17,))])
def test_average_intra_pod_matches_the_reference_bit_for_bit(grid, shape):
    w, x, want, got = _pod_case(grid, shape, seed=sum(grid) + len(shape))
    assert got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    P, A = grid
    for p in range(P):   # broadcast back over the pod
        assert (got[p] == got[p, :1]).all()


@pytest.mark.parametrize("grid,N", [((4, 3), 513), ((3, 5), 33), ((5, 4), 17)])
def test_average_intra_pod_where_the_reference_takes_an_unfused_tail(grid, N):
    """P, A >= 3 and N = 1 (mod 16): every column but the last is equal bit
    for bit; the reference's last column is the rounded-product sum, and
    the pod route's FMA chain lies within A roundings of it."""
    w, x, want, got = _pod_case(grid, (N,), seed=N)
    np.testing.assert_array_equal(_bits(got[..., :-1]), _bits(want[..., :-1]))
    wi = tref.intra_pod_weights(torch.from_numpy(w))
    tail = torch.zeros(grid[0])
    for a in range(grid[1]):
        tail = tail + wi[:, a] * torch.from_numpy(x[:, a, -1])
    np.testing.assert_array_equal(_bits(tail), _bits(want[:, 0, -1]))
    mag = (wi.numpy()[:, :, None] * np.abs(x)).sum(1)[:, -1]
    bound = grid[1] * np.spacing(mag.astype(np.float32))
    assert (np.abs(got[:, 0, -1] - want[:, 0, -1]) <= bound).all()


def test_intra_pod_weights_are_the_reference_bits():
    rng = np.random.default_rng(3)
    for grid in ((2, 4), (4, 3), (3, 16)):
        w = rng.random(grid).astype(np.float32) + 0.01
        want = jnp.asarray(w) / jnp.sum(jnp.asarray(w), axis=1, keepdims=True)
        got = tref.intra_pod_weights(torch.from_numpy(w))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_average_intra_pod_refuses_non_float32_leaves():
    """Integer leaves pass through untouched; a float64 leaf (the
    reference's einsum in float64, which no route of the port computes)
    is still refused, and the message names what is ported."""
    w = torch.full((2, 2), 0.25)
    n = torch.ones((2, 2), dtype=torch.int32)
    out = tcoll.average_intra_pod({"n": n}, w)
    assert out["n"] is n
    with pytest.raises(NotImplementedError, match="ported: float32, bfloat16, float16"):
        tcoll.average_intra_pod({"d": torch.ones((2, 2, 3), dtype=torch.float64)}, w)


# (P, A, N): small, a pod of 9 agents, the shape where the float32 einsum
# takes an unfused tail (not in bf16/f16), and the ACGAN generator bucket
LOW_POD_SHAPES = [(2, 4, 1001), (2, 9, 4097), (3, 3, 17), (2, 4, 2_314_435)]


def _low_pod(dtype, w, x):
    """``average_intra_pod`` of one ``dtype`` leaf (``x`` float32 numpy
    rounded to it) in both packages: (port, reference) as float32 bits."""
    jt, tt = _DTYPES[dtype][:2]
    jx, tx = _as(jt, tt, x)
    want = jcoll.average_intra_pod({"x": jx}, jnp.asarray(w))["x"]
    got = tcoll.average_intra_pod({"x": tx}, torch.from_numpy(w))["x"]
    assert got.dtype == tt and tuple(got.shape) == x.shape
    for p in range(w.shape[0]):   # broadcast back over the pod
        assert bool((got[p] == got[p, :1]).all())
    return _bits(got), _bits(want.astype(jnp.float32))


@pytest.mark.parametrize("shape", LOW_POD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_average_intra_pod_matches_the_reference(dtype, shape):
    """On a bfloat16 or float16 leaf the reference's einsum runs in that
    type: the port's pod route equals it on every element, the (3, 3, 17)
    shape included (the float32 einsum's unfused tail does not occur in
    these types)."""
    rng = np.random.default_rng(shape[2])
    w = rng.uniform(0.5, 2.0, shape[:2]).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    got, want = _low_pod(dtype, w, x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("A", [1, 3, 4, 9])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_average_intra_pod_at_every_residue(dtype, P, A):
    """N over every residue mod 16 (33 to 48 columns), at mixed
    magnitudes, bit for bit."""
    rng = np.random.default_rng(100 * P + A)
    w = _weights((P, A), rng)
    for N in range(33, 49):
        x = (rng.standard_normal((P, A, N))
             * rng.choice([1e-3, 1.0, 30.0], (P, A, N))).astype(np.float32)
        got, want = _low_pod(dtype, w, x)
        np.testing.assert_array_equal(got, want, err_msg=f"N = {N}")


def _rounds_up(w, dtype):
    """Whether some pod's weights, normalised as the reference normalises
    them and rounded to ``dtype``, sum past 65,520 / 65,504: a mean of
    float16's largest value then rounds to inf."""
    wi = tref.intra_pod_weights(torch.from_numpy(w)).to(dtype).double()
    return bool((wi.sum(1) * 65504 >= 65520).any())


def test_low_precision_average_intra_pod_at_float16_overflow():
    """Values near float16's largest (65,504), positive and negative, with
    weights whose float16 roundings sum past 1: the float32 sum rounds to
    +-inf in float16 on some columns, in both packages alike."""
    rng = np.random.default_rng(0)
    w = next(w for w in (rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32) for _ in range(2000))
             if _rounds_up(w, torch.float16))
    x = (rng.uniform(0.998, 1.0, (2, 3, 257)) * 65504 * rng.choice([-1, 1], (2, 3, 257))
         ).astype(np.float32)
    x[:, :, :64] = np.sign(x[:, :, :64]) * 65504   # whole columns of the largest value
    x[:, :, :32] = 65504
    got, want = _low_pod("float16", w, x)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got.view(np.float32)).any() and np.isfinite(got.view(np.float32)).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_average_intra_pod_with_subnormal_weights(dtype):
    """A pod whose normalised weights fall among float16's subnormals (and
    one below its least, which rounds to 0) beside ordinary ones."""
    rng = np.random.default_rng(1)
    w = np.array([[1e-5, 1.0, 1.0, 1.0], [3e-8, 2e-6, 1.0, 0.5]], np.float32)
    wi = tref.intra_pod_weights(torch.from_numpy(w))
    assert bool((wi.abs() < 6.1e-5).any())
    x = (rng.standard_normal((2, 4, 1000)) * 30).astype(np.float32)
    got, want = _low_pod(dtype, w, x)
    np.testing.assert_array_equal(got, want)


def test_mixed_tree_takes_one_pod_launch_per_dtype(monkeypatch):
    """A tree of float32, bfloat16 and int32 leaves: one pod call per
    inexact dtype (each dtype's leaves bucketed), every leaf the
    reference's bit for bit, the int leaf passed through."""
    rng = np.random.default_rng(2)
    w = _weights((2, 3), rng)
    leaves = {"a": ("float32", (7,)), "b": ("bfloat16", (3, 5)), "c": ("float32", (2, 2)),
              "d": ("bfloat16", (11,)), "e": ("float16", (4,))}
    jtree, ttree = {}, {}
    for k, (dt, shape) in leaves.items():
        jt, tt = _DTYPES[dt][:2]
        jtree[k], ttree[k] = _as(jt, tt, rng.standard_normal((2, 3) + shape).astype(np.float32))
    n = np.arange(6, dtype=np.int32).reshape(2, 3)
    jtree["n"], ttree["n"] = jnp.asarray(n), torch.from_numpy(n)
    calls = []
    real = tcoll.fedavg_pod_flat
    monkeypatch.setattr(tcoll, "fedavg_pod_flat",
                        lambda wt, x: calls.append(x.dtype) or real(wt, x))
    got = tcoll.average_intra_pod(ttree, torch.from_numpy(w))
    want = jcoll.average_intra_pod(jtree, jnp.asarray(w))
    assert sorted(map(str, calls)) == ["torch.bfloat16", "torch.float16", "torch.float32"]
    assert got["n"] is ttree["n"]
    for k in leaves:
        assert got[k].dtype == ttree[k].dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k].astype(jnp.float32)))


def _exact_fma(a, b, c):
    """float32 a * b + c, rounded once to nearest even, from exact
    rationals."""
    exact = fractions.Fraction(float(a)) * fractions.Fraction(float(b)) \
        + fractions.Fraction(float(c))
    lo = np.float32(float(exact))         # within one float32 ulp of exact
    best = min((np.nextafter(lo, np.float32(-np.inf)), lo,
                np.nextafter(lo, np.float32(np.inf))),
               key=lambda v: (abs(fractions.Fraction(float(v)) - exact),
                              int(np.float32(v).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_emulation_rounds_once():
    """``fma_f32`` (the pod route's plain version) against exact rationals,
    on random triples and on a triple where a float64 sum lands on a
    float32 midpoint that the exact sum is not on: rounded twice, it goes
    the wrong way."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(300).astype(np.float32)
    b = (rng.standard_normal(300) * 2.0 ** rng.integers(-30, 30, 300)).astype(np.float32)
    c = rng.standard_normal(300).astype(np.float32)
    trap = (np.float32(1 + 2 ** -23), np.float32(2 ** -24 * (1 - 2 ** -23)),
            np.float32(1 + 2 ** -23))
    a, b, c = (np.append(v, t) for v, t in zip((a, b, c), trap))
    got = tref.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = np.float32(np.float64(trap[0]) * np.float64(trap[1]) + np.float64(trap[2]))
    assert twice != want[-1] == np.float32(1 + 2 ** -23)


@pytest.mark.parametrize("lead", [(5,), (1, 5), (2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_tree_matches_jax(lead, dtype):
    """The pytree wrapper against the JAX ``fedavg_tree`` (interpret mode):
    agent axis B or (P, A) consumed, each leaf's dtype kept."""
    rng = np.random.default_rng(len(lead))
    B = int(np.prod(lead))
    w = rng.random(B).astype(np.float32) + 0.1
    w /= w.sum()
    jt, tt = _DTYPES[dtype][:2]
    jtree, ttree = {}, {}
    for k, s in {"a": (130,), "b": (3, 4)}.items():
        jtree[k], ttree[k] = _as(jt, tt, rng.standard_normal(lead + s).astype(np.float32))
    want = jfedavg_tree(jnp.asarray(w), jtree, interpret=True)
    got = fedavg_tree(torch.from_numpy(w), ttree)
    for k, x in jtree.items():
        g, j = got[k], np.asarray(want[k].astype(jnp.float32))
        assert g.dtype == tt and tuple(g.shape) == x.shape[len(lead):]
        xf = np.asarray(x.astype(jnp.float32)).reshape(B, -1)
        bound = 1e-6 * np.abs(w[:, None] * xf).sum(0).reshape(j.shape)
        if dtype == "bfloat16":
            bound = bound + np.abs(j) * 2.0 ** -7
        assert np.all(np.abs(g.float().numpy() - j) <= bound)
        np.testing.assert_array_equal(
            _bits(g), _bits(tref.fedavg_tree_ref(torch.from_numpy(w), ttree)[k]))
    for fn in (fedavg_tree, tref.fedavg_tree_ref):
        with pytest.raises(ValueError, match="incompatible"):
            fn(torch.from_numpy(w), {"x": torch.zeros(3, 4)})
