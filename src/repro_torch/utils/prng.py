"""The reference's fixed-key draws, reproduced bit for bit in numpy.

Two tables of the reference are drawn from fixed keys, never from the run
seed: the similarity sampler's sketch projection (key 0x5CE7C) and the
Markov fault model's stationary start (key 0x0A11).  They must be the same
on every backend, so this module computes them as the reference's PRNG
does: Threefry-2x32 (20 rounds) over a 64-bit counter split into two
32-bit halves, the two output words XORed (the partitionable layout), and
f32 uniforms from the top 23 bits under the exponent of 1.0.
"""
from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter pairs (x0, x1) (uint32 arrays) under
    `key` (two uint32 words); returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int):
    """The key of a 32-bit integer seed: (0, seed)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def random_bits(key, shape):
    """32 random bits per element of `shape`."""
    n = math.prod(shape)
    lo = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (lo >> np.uint64(32)).astype(np.uint32),
                          (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape):
    """f32 uniforms in [0, 1)."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def rademacher(key, shape):
    """f32 signs: +1 where the uniform falls below 0.5, else -1."""
    return np.where(uniform(key, shape) < np.float32(0.5), np.float32(1.0),
                    np.float32(-1.0))
