"""The port's SSD scan on the CPU: its plain version (what the wrapper
computes for CPU tensors) against the reference's Pallas kernel in
interpret mode and its jnp oracle, and the chunked scan against the
one-step recurrence.  The CUDA kernel against the plain version on the
card is in ``test_torch_cuda.py``.

Tolerances, with their reasons: the chunked scan sums exponentially
decayed products in another order on each side, so the outputs are held
to ``3e-6`` of max |y| as the reference holds its own kernel
(``tests/test_kernels.py``); with bfloat16 x the outputs round once at the
end and may take the neighbouring bfloat16, one ulp (2^-7 of the larger
magnitude) on top; the recurrence against the chunked scan within 1e-5,
as in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES
from torch_shared import one_torch_thread  # noqa: F401

from repro.kernels.ssd_scan.ops import ssd as jssd
from repro.kernels.ssd_scan.ref import ssd_decode_ref as jssd_decode_ref
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref

from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_decode_ref, ssd_ref


def _softplus(x):
    return np.logaddexp(0.0, x).astype(np.float32)


def _inputs(T, nh, hd, ds, seed=0, Bsz=2):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((Bsz, T, nh, hd)).astype(np.float32),
            _softplus(rng.standard_normal((Bsz, T, nh)).astype(np.float32)),
            -np.exp(rng.standard_normal(nh)).astype(np.float32),
            0.5 * rng.standard_normal((Bsz, T, ds)).astype(np.float32),
            0.5 * rng.standard_normal((Bsz, T, ds)).astype(np.float32))


def _torch(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("T,nh,hd,ds,chunk,head_block", SSD_CASES)
def test_ssd_plain_matches_jax_kernel(T, nh, hd, ds, chunk, head_block):
    xs = _inputs(T, nh, hd, ds)
    before = skernel.ssd_bthd.launches
    got = ssd(*_torch(xs), chunk=chunk).numpy()
    assert skernel.ssd_bthd.launches == before   # CPU: the plain version
    want = np.asarray(jssd(*(jnp.asarray(x) for x in xs), chunk=chunk,
                           head_block=head_block, interpret=True))
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-6)


def test_ssd_plain_matches_jax_ref_bf16():
    """bfloat16 x, B and C, as the model feeds them, at mamba2's head_dim
    and chunk (T a multiple of the chunk); the final state too."""
    x, dt, A, B, C = _inputs(256, 3, 64, 32, seed=1)
    x, B, C = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    got, state = ssd_ref(x, torch.from_numpy(dt), torch.from_numpy(A), B, C, chunk=128,
                         return_final_state=True)
    jx, jB, jC = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (x, B, C))
    want, jstate = jssd_ref(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=128,
                            return_final_state=True)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    bound = 3e-6 * scale + 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()
    np.testing.assert_allclose(state.numpy() / scale, np.asarray(jstate) / scale, atol=3e-6)


def test_ssd_decode_ref_matches_jax():
    rng = np.random.default_rng(2)
    Bsz, nh, hd, ds = 2, 3, 8, 4
    state = rng.standard_normal((Bsz, nh, hd, ds)).astype(np.float32)
    x1 = rng.standard_normal((Bsz, nh, hd)).astype(np.float32)
    dt1 = _softplus(rng.standard_normal((Bsz, nh)).astype(np.float32))
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    B1, C1 = (rng.standard_normal((Bsz, ds)).astype(np.float32) for _ in range(2))
    y, new = ssd_decode_ref(*_torch((state, x1, dt1, A, B1, C1)))
    jy, jnew = jssd_decode_ref(*(jnp.asarray(a) for a in (state, x1, dt1, A, B1, C1)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=1e-6)


def test_ssd_matches_sequential_recurrence():
    """Chunked SSD == literal per-step recurrence (port twin of the
    reference's test)."""
    T, nh, hd, ds = 32, 2, 8, 4
    x, dt, A, B, C = _torch(_inputs(T, nh, hd, ds, seed=3))
    want = ssd_ref(x, dt, A, B, C, chunk=8)
    state = torch.zeros((2, nh, hd, ds))
    ys = []
    for t in range(T):
        y, state = ssd_decode_ref(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), want.numpy(), atol=1e-5)


def test_ssd_chunk_invariance():
    xs = _torch(_inputs(128, 4, 16, 8, seed=4))
    outs = [ssd_ref(*xs, chunk=c) for c in (8, 16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-4)


def test_ssd_wrapper_refusals():
    x, dt, A, B, C = _torch(_inputs(24, 2, 4, 4, seed=5))
    with pytest.raises(ValueError, match="not divisible"):
        ssd(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="ssd takes x"):
        skernel.ssd_bthd(x, dt[:, :, :1], A, B, C)
