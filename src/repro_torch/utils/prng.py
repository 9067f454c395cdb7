"""The reference's fixed-key draws, reproduced in numpy.

Three tables of the reference are drawn from fixed keys, never from the
run seed: the similarity sampler's sketch projection (key 0x5CE7C), the
Markov fault model's stationary start (key 0x0A11) and the lowrank codec's
starting bases (key 0x10A4, folded with each matrix's index).  They must be
the same on every backend, so this module computes them as the reference's
PRNG does: Threefry-2x32 (20 rounds) over a 64-bit counter split into two
32-bit halves, the two output words XORed (the partitionable layout), and
f32 uniforms from the top 23 bits under the exponent of 1.0.  Keys,
`fold_in`, bits and uniforms are bitwise the reference's.  Normals go
through the reference's f32 erfinv polynomial (Giles' single-precision
approximation, with the fused multiply-adds XLA emits); its log1p is
numpy's, not XLA's, so a normal may lie a few ulps from the reference's
(at most 3 over the lowrank bases of LeNet-5, `tests/test_torch_codecs.py`).
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


def fold_in(key, data: int):
    """The key `key` folded with the 32-bit integer `data`: Threefry-2x32
    of the counter pair (0, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


# Giles' single-precision erfinv, the reference compiler's coefficients:
# for w = -log1p(-x^2) below 5 and from 5 up
_ERFINV_LT5 = np.float32([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941])
_ERFINV_GE5 = np.float32([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682])


def _fma32(a, b, c):
    """a * b + c rounded once to f32 (the product of two f32 is exact in
    f64)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def erfinv32(x):
    """f32 erfinv of x in (-1, 1); +-inf-scaled at +-1."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-(x * x))
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, np.where(lt, lo, hi).astype(np.float32))
    return np.where(np.abs(x) == np.float32(1.0),
                    x * np.finfo(np.float32).max, p * x).astype(np.float32)


def normal(key, shape):
    """f32 standard normals: sqrt(2) erfinv(u), u uniform on
    (-1 + ulp, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, uniform(key, shape) * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2.0)) * erfinv32(u)).astype(np.float32)
