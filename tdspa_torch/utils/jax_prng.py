"""NumPy port of ``jax.random.uniform`` for a fixed key (threefry2x32).

The 3DSPA bottleneck dithers its quantized latents with
``jax.random.uniform(jax.random.PRNGKey(0), shape)`` on every call; that
noise is part of the trained function, so the port reproduces it bit for
bit. With ``jax_threefry_partitionable`` (JAX's default) element ``i`` of a
draw depends only on its flat index ``i``: its bits are
``x0 ^ x1`` of ``threefry2x32(key, (hi32(i), lo32(i)))``, so one
counter-mode function covers every shape.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """20-round Threefry-2x32 of counter words ``(x0, x1)`` under ``key``."""
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
    """float32 ``jax.random.uniform(jax.random.PRNGKey(seed), shape)``."""
    size = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(size, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)
    b0, b1 = threefry2x32(key, hi, lo)
    bits = b0 ^ b1
    # 23 random mantissa bits under the exponent of 1.0, minus 1.0: [0, 1).
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(shape)
