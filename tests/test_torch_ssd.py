"""The port's SSD scan on the CPU: its plain version (what the wrapper
computes for CPU tensors) against the reference's Pallas kernel in
interpret mode and its jnp oracle, and the chunked scan against the
one-step recurrence; and a plain emulation of the CUDA kernel's three
phases (chunk states, state pass, chunk outputs) against both.  The CUDA
kernel against the plain version on the card is in ``test_torch_cuda.py``.

Tolerances, with their reasons: the chunked scan sums exponentially
decayed products in another order on each side, so the outputs are held
to ``3e-6`` of max |y| as the reference holds its own kernel
(``tests/test_kernels.py``); with bfloat16 x the outputs round once at the
end and may take the neighbouring bfloat16, one ulp (2^-7 of the larger
magnitude) on top; the recurrence against the chunked scan within 1e-5,
as in the reference.
"""
import itertools

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


HB, QR = 4, 64   # the CUDA kernel's heads per block and query rows per block


def _three_phases(x, dt, A, B, C, *, chunk, late=False, final=False, early=False):
    """The CUDA kernel's decomposition, in float32, as ``csrc/ssd_scan.cu``
    orders it.  The workspace holds NS = NC - 1 states, NC with the
    ``final`` state.  Phase 1: per (batch, chunk c < NS, head) the local
    end state S_loc^T = B^T (w u) into slot c of a workspace, with L_last.
    Phase 2: slot c overwritten in place with the state entering chunk c + 1,
    exp(L_last) run + S_loc; with ``final``, the last run (the state after
    the last step) is also written out transposed, (hd, ds).  Phase 3: per
    (batch, chunk, QR query rows, block of HB heads, the last block
    partial) C.B^T of those rows against the keys up to the last of them,
    once for the block; per head y = exp(L) (C . S_in^T) + M u, M the
    decayed, masked C.B^T.  ``late`` plants a fault: chunk c reads the
    state entering chunk c - 1; ``early`` another: the final state is the
    one entering the last chunk.  Returns y, or (y, final state)."""
    Bsz, T, nh, hd = x.shape
    Q = min(chunk, T)
    NC = T // Q
    NS = NC - 1 + int(final)
    xf, Bf, Cf = x.float(), B.float(), C.float()

    def cumsum(b, c, h):
        return torch.cumsum(A[h] * dt[b, c * Q:(c + 1) * Q, h], 0)

    def u(b, c, h, n):
        t = slice(c * Q, c * Q + n)
        return dt[b, t, h, None] * xf[b, t, h]

    ws = torch.empty((Bsz, NS, nh, B.shape[-1], hd))
    Llast = torch.empty((Bsz, NS, nh))
    state = torch.empty((Bsz, nh, hd, B.shape[-1]))
    for b, c, h in itertools.product(range(Bsz), range(NS), range(nh)):
        L = cumsum(b, c, h)
        w = torch.exp(L[-1] - L)
        ws[b, c, h] = Bf[b, c * Q:(c + 1) * Q].T @ (u(b, c, h, Q) * w[:, None])
        Llast[b, c, h] = L[-1]
    for b, h in itertools.product(range(Bsz), range(nh)):
        run = torch.zeros((B.shape[-1], hd))
        for c in range(NS):
            run = torch.exp(Llast[b, c, h]) * run + ws[b, c, h]
            ws[b, c, h] = run
        if final:
            state[b, h] = (ws[b, NS - 2, h] if early and NS > 1 else run).T
    y = torch.empty((Bsz, T, nh, hd))
    for b, c, q0, h0 in itertools.product(range(Bsz), range(NC), range(0, Q, QR),
                                          range(0, nh, HB)):
        q1, P = min(q0 + QR, Q), min(Q, q0 + QR)
        rows = slice(c * Q + q0, c * Q + q1)
        CB = Cf[b, rows] @ Bf[b, c * Q:c * Q + P].T          # once per head block
        qi = torch.arange(q0, q1)[:, None]
        mask = qi >= torch.arange(P)[None, :]
        for h in range(h0, min(h0 + HB, nh)):
            L = cumsum(b, c, h)
            k = c - 2 if late else c - 1
            acc = torch.zeros((q1 - q0, hd))
            if k >= 0:
                acc = torch.exp(L[q0:q1])[:, None] * (Cf[b, rows] @ ws[b, k, h])
            decay = torch.exp(torch.clamp(L[q0:q1, None] - L[None, :P], max=0.0))
            M = torch.where(mask, CB * decay, 0.0)
            y[b, rows, h] = acc + M @ u(b, c, h, P)
    return (y.to(x.dtype), state) if final else y.to(x.dtype)


def _scaled_err(got, want):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-6)


@pytest.mark.parametrize("T,nh,hd,ds,chunk,head_block",
                         SSD_CASES + [(256, 6, 32, 16, 64, 4)])   # a partial head block
def test_three_phase_decomposition_matches_jax_kernel(T, nh, hd, ds, chunk, head_block):
    """The CUDA kernel's three phases, emulated, against the reference's
    Pallas kernel in interpret mode and the port's plain version, at the
    reference's own 3e-6 of max |y|, on the inputs that hold the plain
    version to the Pallas kernel above.  The emulation is within 1e-7 of
    max |y| of the plain version; at chunk 128 both are 3.0e-6 from the
    Pallas kernel, each summing 128 decayed products in its own order."""
    xs = _inputs(T, nh, hd, ds)
    got = _three_phases(*_torch(xs), chunk=chunk).numpy()
    want = np.asarray(jssd(*(jnp.asarray(x) for x in xs), chunk=chunk,
                           head_block=head_block, interpret=True))
    assert _scaled_err(got, want) <= 3e-6
    assert _scaled_err(got, ssd_ref(*_torch(xs), chunk=chunk).numpy()) <= 3e-6


def test_three_phase_decomposition_rejects_a_late_state():
    """Planted fault: each chunk reads the state one chunk late.  At chunk
    128 (two blocks of query rows) and six heads (a partial head block),
    the emulation holds to the plain version and the fault does not."""
    xs = _torch(_inputs(512, 6, 32, 64, seed=7))
    want = ssd_ref(*xs, chunk=128).numpy()
    assert _scaled_err(_three_phases(*xs, chunk=128).numpy(), want) <= 3e-6
    assert _scaled_err(_three_phases(*xs, chunk=128, late=True).numpy(), want) > 100 * 3e-6


# ---------------------------------------------------------------------------
# the final state (the decode cache of a prefill through the kernel)
# ---------------------------------------------------------------------------

# (T, nh, hd, ds, chunk): several chunks; one chunk (NS = 1: phases 1 and 2
# then run only for the final state); zamba2-7b's head_dim 64 and state 64
# at a reduced width and length
FINAL_CASES = [(64, 4, 16, 8, 16), (32, 2, 8, 4, 32), (256, 6, 64, 64, 128)]


@pytest.mark.parametrize("T,nh,hd,ds,chunk", FINAL_CASES)
def test_ssd_final_state_matches_jax(T, nh, hd, ds, chunk):
    """``ssd(return_final_state=True)`` on the CPU (the wrapper's plain
    version, no launch): the (Bsz, nh, hd, ds) float32 state against the
    reference's ``ssd_ref`` within 1e-5 of its max, the bound the reference
    holds its chunked scan to the recurrence by (the state is the
    recurrence's, and at chunk 128 the cumsum L of dt A reaches several
    hundred, summed in each package's own order: 4.8e-6 at the third
    case), and the output the port's own without the state, exactly (the
    output against the reference is held above)."""
    xs = _inputs(T, nh, hd, ds, seed=11)
    before = skernel.ssd_bthd.launches
    y, state = ssd(*_torch(xs), chunk=chunk, return_final_state=True)
    assert skernel.ssd_bthd.launches == before
    _, jstate = jssd_ref(*(jnp.asarray(x) for x in xs), chunk=chunk,
                         return_final_state=True)
    assert state.shape == (2, nh, hd, ds) and state.dtype == torch.float32
    assert _scaled_err(state.numpy(), jstate) <= 1e-5
    assert torch.equal(y, ssd(*_torch(xs), chunk=chunk))


@pytest.mark.parametrize("T,nh,hd,ds,chunk", FINAL_CASES)
def test_three_phase_final_state(T, nh, hd, ds, chunk):
    """The kernel's decomposition with its final state (phase 1 over every
    chunk, phase 2's last run written transposed): the output and the state
    within 3e-6 of the plain version's; the output the same as without the
    state.  Planted fault: the state entering the last chunk in its place
    (where there are two or more chunks) fails."""
    xs = _torch(_inputs(T, nh, hd, ds, seed=12))
    y, state = _three_phases(*xs, chunk=chunk, final=True)
    wy, wstate = ssd_ref(*xs, chunk=chunk, return_final_state=True)
    assert _scaled_err(y.numpy(), wy.numpy()) <= 3e-6
    assert _scaled_err(state.numpy(), wstate.numpy()) <= 3e-6
    assert _scaled_err(_three_phases(*xs, chunk=chunk).numpy(), y.numpy()) == 0.0
    if T > chunk:
        _, bad = _three_phases(*xs, chunk=chunk, final=True, early=True)
        assert _scaled_err(bad.numpy(), wstate.numpy()) > 100 * 3e-6


def test_mamba_block_kernel_state_matches_jax():
    """``Mamba2Block(use_kernel=True).apply(return_state=True)``: through the
    kernel's wrapper (on the CPU its plain version), the output and the
    decode cache (the scan's final state, the conv tails) against the
    reference's block with its kernel flag, and bit for bit the port's
    flag-free block."""
    from test_models import CFGS as JCFGS
    from test_torch_backbone import _leaves_close, port_config
    from repro.models.ssm import Mamba2Block as JMamba
    from repro_torch.convert import backbone_params_from_jax
    from repro_torch.models.ssm import Mamba2Block
    jcfg = JCFGS["ssm"]
    jm = JMamba(jcfg, use_kernel=True)
    tm, plain = Mamba2Block(port_config(jcfg), use_kernel=True), Mamba2Block(port_config(jcfg))
    jp = jax.device_get(jm.init(jax.random.key(3)))
    tp = backbone_params_from_jax(jp, device="cpu")
    u = np.random.default_rng(6).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jy, jst = jm.apply(jp, jnp.asarray(u), return_state=True)
    ty, tst = tm.apply(tp, torch.from_numpy(u), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    _leaves_close(tst, jst, 1e-5)
    py, pst = plain.apply(tp, torch.from_numpy(u), return_state=True)
    assert torch.equal(ty, py) and all(torch.equal(tst[k], pst[k]) for k in pst)
