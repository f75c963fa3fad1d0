"""Threefry-2x32 in numpy: the bits of the reference's ``jax.random``.

The participation schedule (``core/participation.py``) draws each round's
cohort from ``jax.random.uniform(fold_in(key(seed), round_idx), (n,))`` in
the reference.  The port has no JAX, so it computes the same bits on the
host: ``key``, ``fold_in``, 32-bit ``random_bits`` and ``uniform``, with
the counter layout of ``jax_threefry_partitionable=True`` (JAX's default
since 0.5): element i of a draw hashes the 64-bit counter i as the word
pair (hi, lo) and keeps ``out0 ^ out1``.

A key is a (2,) uint32 array, as ``jax.random.key_data`` gives it.
"""
from __future__ import annotations

import numpy as np

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


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the pair (0, data) under ``k``."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def random_bits(k, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)`` under the partitionable
    layout: counter i is the pair (i >> 32, i & 0xFFFFFFFF)."""
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(k, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def uniform(k, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))``, float32 in [0, 1): the top 23 bits
    as a mantissa under the exponent of 1.0, minus 1."""
    bits = (random_bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0), np.float32(0.0))
