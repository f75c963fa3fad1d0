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
"""
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
from repro_torch.kernels.flash_attention.ref import attention_ref


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,nh,nkv,hd,causal,window", FLASH_CASES)
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
