"""Flax layers the feature networks use, with flax's parameter names, layouts
and numerics (beside ``core/attention.py``'s ``DenseGeneral`` and bias-free
norms).

* ``LayerNorm``: scale and bias, f32 statistics with flax's fast variance
  (E[x^2] - E[x]^2, clipped at 0), output in ``dtype``; flax's default eps is
  1e-6, not torch's 1e-5.
* ``GroupNorm``: the same per group of channels over every spatial position.
* ``Conv``: kernel ``[kh, kw, in, out]``, channel-last activations
  ``[B, H, W, C]``; input, kernel and bias cast to ``dtype``. Runs
  ``F.conv2d`` on a channels-last view, so no activation is copied to NCHW.
* ``ConvTranspose``: flax's ``ConvTranspose`` with stride = kernel size
  (``transpose_kernel=False``, ``SAME``): it correlates with the kernel
  unflipped, so ``F.conv_transpose2d`` gets it flipped spatially and
  transposed to ``[in, out, kh, kw]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from tdspa_torch.core.attention import lecun_normal_
from tdspa_torch.kernels.norm import row_norm_reference


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, with scale and bias."""

    def __init__(self, width: int, eps: float = 1e-6, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(width, device=device))
        self.bias = nn.Parameter(torch.empty(width, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_norm_reference(x, self.scale, True, self.dtype, self.bias, self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on ``[B, ..., C]``: statistics per item and group."""

    def __init__(self, num_groups: int, width: int, eps: float = 1e-5, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.scale = nn.Parameter(torch.empty(width, device=device))
        self.bias = nn.Parameter(torch.empty(width, device=device))

    reset_parameters = LayerNorm.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        grouped = x.float().reshape(x.shape[0], -1, self.num_groups, c // self.num_groups)
        mean = grouped.mean((1, 3), keepdim=True)
        var = torch.clamp((grouped * grouped).mean((1, 3), keepdim=True) - mean * mean, min=0.0)
        scale = self.scale.reshape(self.num_groups, -1)
        bias = self.bias.reshape(self.num_groups, -1)
        out = (grouped - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        return out.reshape(x.shape).to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` on channel-last input; ``padding`` pixels on every side."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_features, out_features, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device)) if use_bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.kernel, math.prod(self.kernel.shape[:3]), generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)  # [out, in, kh, kw]
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with ``strides`` equal to the kernel size."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.stride, self.dtype = kernel_size, dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_features, out_features, device=device)
        )
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    reset_parameters = Conv.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).flip(0, 1).permute(2, 3, 0, 1)  # [in, out, kh, kw]
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                               self.bias.to(self.dtype), self.stride)
        return y.permute(0, 2, 3, 1)


def init_parameters(module: nn.Module, seed: int, device) -> None:
    """Seeded flax-law initialisation of ``module`` and everything under it."""
    generator = torch.Generator(device=device).manual_seed(seed)
    for sub in module.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator)
