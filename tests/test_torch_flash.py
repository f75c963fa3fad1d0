"""The port's flash attention on the CPU: its plain version (what the
wrapper computes for CPU tensors) against the reference's Pallas kernel in
interpret mode and its jnp oracle.  The CUDA kernel against the plain
version on the card is in ``test_torch_cuda.py``.

Tolerances, with their reasons:

* float32: within 2e-5 absolute, as the reference holds its own kernel to
  its oracle (``tests/test_kernels.py``): both sides compute in float32 and
  differ in the order of the sums inside the products and the softmax.
* bfloat16 inputs and outputs: both sides compute in float32 from the same
  bf16 values and round once at the end, so they may round to neighbouring
  bfloat16 values: one bf16 ulp, at most 2^-7 of the larger magnitude.

The card's bfloat16 kernel computes p.v on the tensor cores with p split
into two bfloat16 halves.  That design is emulated here in plain PyTorch
and held to the card test's bound, with a planted fault (p rounded to
bfloat16 alone, the usual flash design) that must fail it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_CASES
from torch_shared import one_torch_thread  # noqa: F401

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref

from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref


def _inputs(B, T, S, nh, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, nh, hd)).astype(np.float32),
            rng.standard_normal((B, S, nkv, hd)).astype(np.float32),
            rng.standard_normal((B, S, nkv, hd)).astype(np.float32))


def _bf16(x):
    """float32 values exactly representable in bfloat16."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5)
    else:
        bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


# zamba2-7b's shared attention (head_dim 112, a multiple of no power of two
# above 16) and whisper's encoder (non-causal), T a multiple of no tile
NEW_CASES = [(128, 128, 4, 4, 112, True, 0), (150, 150, 4, 2, 112, True, 0),
             (150, 150, 4, 4, 64, False, 0), (96, 96, 2, 2, 112, False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,nh,nkv,hd,causal,window", FLASH_CASES + NEW_CASES)
def test_flash_plain_matches_jax_kernel(T, S, nh, nkv, hd, causal, window, dtype):
    q, k, v = _inputs(2, T, S, nh, nkv, hd)
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    before = fkernel.flash_attention_bhsd.launches
    got = flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
                          causal=causal, window=window)
    assert fkernel.flash_attention_bhsd.launches == before   # CPU: the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, T, nh, hd)
    want = jflash(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)), causal=causal,
                  window=window, interpret=True)
    _assert_close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("nh,nkv,window", [(8, 4, 16), (4, 4, 0), (8, 1, 5)])
def test_attention_ref_matches_jax_ref(nh, nkv, window):
    """The plain version against the reference's oracle in (B, nh, T, hd)
    layout, at gemma3's head_dim and GQA 2:1 among others, T not a multiple
    of any tile."""
    q, k, v = _inputs(2, 37, 37, nh, nkv, 256, seed=1)
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                        window=window)
    want = jattention_ref(*(jnp.asarray(x) for x in (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_wrapper_layouts_and_refusals():
    """The model-layout entry point is the (B, nh, T, hd) one with the head
    axis moved; the wrapper refuses shapes the kernel cannot take."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 20, 20, 4, 2, 32, seed=2))
    got = flash_attention(q, k, v, causal=True, window=7)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=True, window=7).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="nkv dividing nh"):
        fkernel.flash_attention_bhsd(torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8),
                                     torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError, match="nkv dividing nh"):
        fkernel.flash_attention_bhsd(torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 4, 8),
                                     torch.zeros(1, 2, 5, 8))


def _card_bound_ratio(got, want):
    """The largest error over the bound of ``test_torch_cuda.py``'s
    ``_close`` for bfloat16 (copied, with its reason): the kernel computes
    in float32 with another order of sums than the plain version's library
    products, so within 1e-5 of max |want|, plus two bfloat16 ulps (2^-6 of
    the larger magnitude) of the element, since both round a float32
    result once, which may land on the neighbouring value.  At most 1
    passes."""
    g, w = got.float(), want.float()
    bound = 1e-5 * float(w.abs().max()) + 2.0 ** -6 * torch.maximum(g.abs(), w.abs())
    return float(((g - w).abs() / bound).max())


def _tensor_core_emulation(q, k, v, *, causal, window, split):
    """The arithmetic of the card's bfloat16 kernel (``flash_fwd_tc``) in
    plain PyTorch: online softmax over tiles of the kernel's BK keys (32 at
    hd 256, else 64), scores from bf16 inputs in float32, p.v as p_hi.v +
    p_lo.v with p_hi = bf16(p) and p_lo = bf16(p - p_hi) (``split``; else
    p_hi.v alone), float32 accumulation, the output rounded to bf16 once."""
    B, nh, T, hd = q.shape
    nkv, S = k.shape[1], k.shape[2]
    bk = 32 if hd >= 256 else 64
    kf, vf = (x.float().repeat_interleave(nh // nkv, dim=1) for x in (k, v))
    qf = q.float()
    m = torch.full((B, nh, T, 1), NEG_INF)
    l = torch.zeros((B, nh, T, 1))
    acc = torch.zeros((B, nh, T, hd))
    qpos = torch.arange(T)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((T, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window > 0:
            ok &= qpos - kpos < window
        s = torch.where(ok, (qf @ kt.transpose(-1, -2)) / math.sqrt(hd), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        acc = acc * alpha + p_hi @ vt
        if split:
            acc = acc + (p - p_hi).bfloat16().float() @ vt
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


def _card_inputs(nh, nkv, hd, window):
    """The card test's shapes (``test_flash_kernel_matches_plain``): B = 2,
    T = S = 300, standard normal bf16, seeded as there by hd + window."""
    rng = np.random.default_rng(hd + window)
    return tuple(torch.from_numpy(rng.standard_normal((2, n, 300, hd), dtype=np.float32))
                 .bfloat16() for n in (nh, nkv, nkv))


@pytest.mark.parametrize("split", [True, False], ids=["p_split", "planted_p_in_bf16"])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("nh,nkv,hd", [(8, 4, 256), (4, 4, 64), (8, 2, 32), (4, 4, 112)])
def test_tensor_core_design_against_the_card_bound(nh, nkv, hd, window, split):
    """p split in two bf16 halves meets the card test's bound with the
    margin float32 p has (measured 0.47-0.49 of it); p rounded to bf16
    alone fails it many times over (measured 16-30x), so that design is
    kept out of the kernel."""
    q, k, v = _card_inputs(nh, nkv, hd, window)
    want = attention_ref(q, k, v, causal=True, window=window)
    ratio = _card_bound_ratio(
        _tensor_core_emulation(q, k, v, causal=True, window=window, split=split), want)
    assert (ratio <= 1.0) == split, ratio


@pytest.mark.parametrize("split", [True, False], ids=["p_split", "planted_p_in_bf16"])
@pytest.mark.parametrize("hd", [64, 112])
def test_tensor_core_design_non_causal(hd, split):
    """The same design on a non-causal head (whisper's encoder: every key
    of every tile live for every row) meets the card bound with p split
    and fails it with p in bf16 alone."""
    q, k, v = _card_inputs(4, 4, hd, 0)
    want = attention_ref(q, k, v, causal=False)
    ratio = _card_bound_ratio(_tensor_core_emulation(q, k, v, causal=False, window=0,
                                                     split=split), want)
    assert (ratio <= 1.0) == split, ratio


def _tile_copies(hd, rows, threads=128, flat=True):
    """How many times the bf16 kernel's tile copy (``copy_rows`` in
    ``csrc/flash_attention.cu``) writes each 16-byte chunk of a ``rows`` x
    ``hd`` tile: thread t takes chunks t, t + threads, ... (``flat``), or,
    where the chunks of a row divide the block, a fixed column and rows t /
    CH, t / CH + threads / CH, ...  ``flat=False`` models the loop at every
    head dim, the design that failed at 112."""
    CH = hd // 8
    count = np.zeros((rows, CH), np.int64)
    for t in range(threads):
        if not flat or threads % CH == 0:
            for r in range(t // CH, rows, threads // CH):
                count[r, t % CH] += 1
        else:
            for i in range(t, rows * CH, threads):
                count[i // CH, i % CH] += 1
    return count


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
def test_tile_copy_takes_each_chunk_once(hd):
    """Every 16-byte chunk of the Q tile (64 rows) and of a K/V tile (64
    rows, 32 at hd 256) is copied exactly once at every head dim the
    kernel is built for.  At hd 112 a row is 14 chunks, which do not divide
    the 128 threads: the fixed-column loop then copies a row twice from two
    threads (threads 126 and 127 start at row 9, which thread 0 also
    takes)."""
    assert hd in fkernel.HEAD_DIMS
    for rows in (64, 32 if hd >= 256 else 64):
        assert (_tile_copies(hd, rows) == 1).all()
    if hd == 112:
        assert (_tile_copies(hd, 64, flat=False) == 2).any()
