"""YUV 4:2:0 wire format of the streamed upload (port of ``tdspa/ops/yuv.py``).

* ``rgb_to_yuv420`` (host, numpy): full-resolution BT.601 luma Y (the LK
  tracker's grayscale weights, so tracking sees lossless luma) plus
  2x2-mean-pooled chroma planes: half the bytes of RGB on the wire.
* ``yuv420_to_rgb`` (device, tensors): the exact inverse of the encode
  matrix with nearest-neighbour chroma upsampling.
"""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_yuv420(rgb: np.ndarray):
    """[T H W 3] uint8 RGB -> (y [T H W], u [T H/2 W/2], v [T H/2 W/2]) uint8.

    H and W must be even. Chroma differences scaled into [0, 255] around
    128 and 2x2 mean-pooled; values rounded half to even and saturated.
    """
    t, h, w = rgb.shape[:3]
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even dimensions, got {h}x{w}")
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) * 0.564 + 128.0
    v = (r - y) * 0.713 + 128.0

    def pool(c):
        return c.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))

    def to8(a):
        return np.clip(np.round(a), 0, 255).astype(np.uint8)

    return to8(y), to8(pool(u)), to8(pool(v))


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of ``rgb_to_yuv420`` -> [T H W 3] uint8 RGB on y's device."""
    yf = y.to(torch.float32)
    uf = u.to(torch.float32).repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    vf = v.to(torch.float32).repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    r = yf + vf / 0.713
    b = yf + uf / 0.564
    g = (yf - 0.299 * r - 0.114 * b) / 0.587
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
