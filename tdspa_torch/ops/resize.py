"""Image resizes with the JAX package's semantics, on channel-last tensors.

* ``resize``: ``jax.image.resize`` with ``method="bilinear"`` or
  ``"bicubic"`` and its default antialiasing. A copy of
  ``jax._src.image.scale.compute_weight_mat`` builds one ``[in, out]``
  weight matrix per resized axis (half-pixel centres; when downsampling
  the kernel widens by the scale, which is the antialiasing; Keys cubic
  with a = -0.5; columns normalised to sum 1) and the resize is two
  contractions with them in the input's dtype, as JAX's einsum is. An axis
  whose size does not change is left as it is.
* ``resize_align_corners``: ``tdspa/features/depth.py::_resize_align_corners``,
  the gather-and-lerp bilinear resize of torch's ``align_corners=True``
  that the DPT head uses, with its products and sums in the same order.
"""

from __future__ import annotations

import functools

import torch


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int, method: str, antialias: bool, device) -> torch.Tensor:
    """Built on the CPU, kept on ``device``: a resize on the card copies no
    weights from the host (a pageable copy would wait for the card)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = _KERNELS[method](x / kernel_scale)
    total = weights.sum(0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool = True,
                  device="cpu") -> torch.Tensor:
    """The f32 ``[in_size, out_size]`` matrix that resizes one axis."""
    if method not in _KERNELS:
        raise ValueError(f"method must be one of {sorted(_KERNELS)}, got {method!r}")
    return _weights(in_size, out_size, method, antialias, torch.device(device))


def resize(x: torch.Tensor, out_hw, method: str = "bilinear", antialias: bool = True):
    """``jax.image.resize(x, (..., oh, ow, C), method)`` for x ``[..., H, W, C]``."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if not x.is_floating_point():
        x = x.float()
    if oh != h:
        wy = weight_matrix(h, oh, method, antialias, x.device).to(x.dtype)
        x = torch.einsum("...hwc,hy->...ywc", x, wy)
    if ow != w:
        wx = weight_matrix(w, ow, method, antialias, x.device).to(x.dtype)
        x = torch.einsum("...ywc,wx->...yxc", x, wx)
    return x


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of torch's ``align_corners=True``: x ``[B H W C]`` -> ``[B oh ow C]``."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x

    def axis(in_size, out_size):
        if out_size == 1 or in_size == 1:
            pos = torch.zeros(out_size, dtype=torch.float32, device=x.device)
        else:
            pos = torch.arange(out_size, dtype=torch.float32, device=x.device) * (
                (in_size - 1) / (out_size - 1)
            )
        lo = torch.clamp(torch.floor(pos).long(), 0, in_size - 1)
        hi = torch.clamp(lo + 1, max=in_size - 1)
        return lo, hi, (pos - lo).to(x.dtype)

    ylo, yhi, yf = axis(h, oh)
    xlo, xhi, xf = axis(w, ow)
    rows_lo = x.index_select(1, ylo)
    rows = rows_lo + (x.index_select(1, yhi) - rows_lo) * yf[None, :, None, None]
    cols_lo = rows.index_select(2, xlo)
    return cols_lo + (rows.index_select(2, xhi) - cols_lo) * xf[None, None, :, None]
