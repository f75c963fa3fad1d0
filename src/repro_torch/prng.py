"""Threefry-2x32 in numpy: the bits of the reference's ``jax.random``.

The participation schedule (``core/participation.py``) draws each round's
cohort from ``jax.random.uniform(fold_in(key(seed), round_idx), (n,))`` in
the reference.  The port has no JAX, so it computes the same bits on the
host: ``key``, ``fold_in``, ``split``, 32-bit ``random_bits``, ``uniform``
(and so ``bernoulli``) and ``randint``, with the counter layout of
``jax_threefry_partitionable=True`` (JAX's default since 0.5): element i
of a draw hashes the 64-bit counter i (row-major over the draw's shape) as
the word pair (hi, lo) and keeps ``out0 ^ out1``; key i of a split keeps
both words.  The host-streaming round pipeline
(``repro_torch.data.federated``) draws its minibatch indices and seeds
from these, and ``data.synthetic.sample_agent_tokens`` the LM GAN's
token streams.

A key is a (2,) uint32 array, as ``jax.random.key_data`` gives it.

The same hash runs over tensors on any device (``threefry2x32_t``,
``key_t``, ``fold_in_t``, ``random_bits_t``): the 32-bit words ride in
int64 tensors, every sum masked to 32 bits.  The secure sum's pairwise
masks (``repro_torch.dist.collectives``) draw their bits so on the card,
from a round key folded from the device's step counter, with no host read.
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of the word pairs (x0, x1) (uint32
    arrays of one shape) under ``key``; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data for a seed in the int32 range: the
    high word 0, the low word the seed's 32 bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def as_key(seed) -> np.ndarray:
    """A driver's root key: ``key(seed)`` for an int seed, else ``seed``
    itself, a key's (2,) uint32 data."""
    if isinstance(seed, (int, np.integer)):
        return key(int(seed))
    k = np.asarray(seed, np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is (2,) uint32 data, got shape {k.shape}")
    return k


def key_seed(k) -> int:
    """The 64-bit integer of key ``k``'s two words, high word first: the
    seed of a ``torch.Generator`` made from a key."""
    return (int(k[0]) << 32) | int(k[1])


def seed_int(seed) -> int:
    """A driver's integer seed: an int as it is, a key as ``key_seed``."""
    if isinstance(seed, (int, np.integer)):
        return int(seed)
    return key_seed(as_key(seed))


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the pair (0, data) under ``k``."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counters(shape):
    """The partitionable layout's counters of a draw of ``shape``: the
    row-major index i as the word pair (i >> 32, i & 0xFFFFFFFF)."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64).reshape(shape)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``'s key data, (n, 2) uint32: key i is both
    output words of the hash of counter i."""
    y0, y1 = threefry2x32(k, *_counters((n,)))
    return np.stack([y0, y1], axis=1)


def random_bits(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)`` under the partitionable
    layout (``shape`` an int or a tuple)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    y0, y1 = threefry2x32(k, *_counters(shape))
    return y0 ^ y1


def uniform(k, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` (``shape`` an int or a tuple),
    float32 in [0, 1): the top 23 bits as a mantissa under the exponent of
    1.0, minus 1.  ``uniform(k, shape) < p`` is ``jax.random.bernoulli(k,
    p, shape)`` for a float ``p``."""
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0), np.float32(0.0))


_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32, bounds in
    the int32 range, as JAX takes them without 64-bit mode): two bit
    streams from ``split(k)``, each reduced modulo the span and combined
    as ``((hi % span) * mult + lo % span) % span`` with ``mult = (2^16 %
    span)^2 % span``, every product wrapping in uint32 as in JAX.  An
    empty range returns ``minval``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    minval, maxval = int(minval), int(maxval)
    if not (_INT32_MIN <= minval <= _INT32_MAX and _INT32_MIN <= maxval <= _INT32_MAX):
        raise ValueError(f"randint bounds must be int32, got [{minval}, {maxval})")
    span = maxval - minval if maxval > minval else 1
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    mask, s = np.uint64(0xFFFFFFFF), np.uint64(span)
    mult = np.uint64((((1 << 16) % span) ** 2 & 0xFFFFFFFF) % span)
    off = ((hi.astype(np.uint64) % s) * mult) & mask
    off = ((off + lo.astype(np.uint64) % s) & mask) % s
    return (off.astype(np.int64) + minval).astype(np.int32)


# ---------------------------------------------------------------------------
# the same hash over tensors: uint32 words in int64, every sum masked
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32_t(k0, k1, x0, x1):
    """``threefry2x32`` over int64 tensors that hold uint32 words: the key
    words ``k0``, ``k1`` and the counter words ``x0``, ``x1`` (each a
    tensor or a Python int) broadcast together.  Returns the two output
    words, int64 in [0, 2^32)."""
    k2 = k0 ^ k1 ^ int(_PARITY)
    ks = (k0, k1, k2)
    x0 = (k0 + x0) & _M32
    x1 = (k1 + x1) & _M32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.clone(), x1.clone()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = _rotl_t(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def key_t(k, device) -> torch.Tensor:
    """Key data ``k`` ((..., 2) uint32, numpy) as an int64 tensor on
    ``device``, each word filled in on the device: no host-to-device
    copy, so a captured round can make it."""
    k = np.asarray(k, np.uint32).astype(np.int64)
    out = torch.empty(k.shape, dtype=torch.int64, device=device)
    for idx, v in np.ndenumerate(k):
        out[idx].fill_(int(v))
    return out


def fold_in_t(k: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` over tensors: ``k`` (..., 2) int64 key data, ``data`` an
    integer tensor or a Python int, broadcast against the keys.  A device
    ``data`` (the step counter) is never read on the host."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    y0, y1 = threefry2x32_t(k[..., 0], k[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def counters_t(n: int, device) -> tuple:
    """The partitionable layout's counter words of a flat draw of ``n``,
    int64 tensors on ``device``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def random_bits_t(k: torch.Tensor, shape) -> torch.Tensor:
    """``random_bits`` over tensors: the uint32 bits of ``jax.random.bits(k,
    shape, uint32)`` as an int64 tensor on ``k``'s device."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    hi, lo = counters_t(int(np.prod(shape)), k.device)
    y0, y1 = threefry2x32_t(k[..., 0], k[..., 1], hi, lo)
    return (y0 ^ y1).reshape(shape)
