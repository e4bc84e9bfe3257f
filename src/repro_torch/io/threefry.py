"""``jax.random``'s threefry2x32 draws, in numpy, for factor-sized arrays.

``repro``'s virtual datasets draw their ground truth (A, R) and their
stored-block patterns from ``jax.random`` keys.  Those draws are small —
O(n k) and (nb_loc, nb_loc) per shard — so the port computes the same
bits on the host: the Threefry-2x32 hash (20 rounds, Salmon et al. 2011)
and JAX's "partitionable" counter layout (the default since JAX 0.5: the
counter of element e of a shape is the 64-bit e split into hi and lo
words), its key derivation (``PRNGKey``, ``split``, ``fold_in``) and its
float construction (``uniform``: the top 23 random bits as a mantissa in
[1, 2), minus 1, scaled with one rounding; ``normal``: sqrt(2) erfinv of
a uniform in (-1, 1); ``exponential``: -log1p(-u)), in float32.
``uniform`` is bit-identical to JAX's; ``normal`` and ``exponential`` go
through transcendental functions that XLA approximates its own way, so
they agree to ~1e-6 relative (``normal`` to ~1e-5 near the tails, where
erfinv is steep).

The value noise of a virtual shard (m * nnzb * bs^2 draws, 820M at the
full-size spec) is not drawn here: the port draws it with torch
generators on the device (``io.virtual.SeededSource``).
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter words (x1, x2) under the key
    (k1, k2): 5 groups of 4 rounds, a key injection after each."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for group in range(5):
            for rot in _ROTATIONS[group % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], rot) ^ x[0]
            x[0] = x[0] + ks[(group + 1) % 3]
            x[1] = x[1] + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (hi, lo) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & 0xFFFFFFFF


def _counters(size: int) -> tuple[np.ndarray, np.ndarray]:
    e = np.arange(size, dtype=np.uint64)
    return ((e >> np.uint64(32)).astype(np.uint32),
            (e & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``."""
    b1, b2 = threefry2x32(*key, *_counters(num))
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    b1, b2 = threefry2x32(*key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return int(b1[0]), int(b2[0])


def random_bits(key: tuple[int, int], shape) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    size = int(np.prod(shape, dtype=np.int64))
    b1, b2 = threefry2x32(*key, *_counters(size))
    return (b1 ^ b2).reshape(shape)


def uniform(key: tuple[int, int], shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``,
    bit for bit."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    # one rounding of floats * (hi - lo) + lo, as XLA's fused multiply-add
    # gives (the product is exact in float64)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def normal(key: tuple[int, int], shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``, to a few ulps."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * torch.special.erfinv(
        torch.from_numpy(u)).numpy()).astype(np.float32)


def exponential(key: tuple[int, int], shape) -> np.ndarray:
    """``jax.random.exponential(key, shape, float32)``, to a few ulps."""
    return -np.log1p(-uniform(key, shape))
