"""``jax.random.uniform(jax.random.PRNGKey(seed), shape)`` in NumPy
(threefry2x32, partitionable counters).

Both track autoencoders dither their quantised latents with this fixed draw,
so it is part of the function the reference computes. Element ``i`` of a
draw takes the bits ``x0 ^ x1`` of ``threefry2x32(key, (hi32(i), lo32(i)))``,
mantissa bits under the exponent of 1.0, minus 1.0.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(step + 1) % 3]
        x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def uniform(shape: tuple[int, ...], seed: int = 0) -> np.ndarray:
    size = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(size, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    b0, b1 = threefry2x32(key, hi, lo)
    bits = b0 ^ b1
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(shape)
