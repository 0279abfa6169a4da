"""Separable Gaussian blur of a [T, H, W] video (port of ``tdspa/ops/filters.py``).

The tracker's denoise tier re-tracks on blurred luma
(``tdspa_torch/features/tracks.py``); this is its blur: two 1-D
convolutions with symmetric (edge-duplicating) padding, scipy's
``gaussian_filter`` 'reflect' convention, so constant regions stay constant.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gauss_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * torch.square(x / sigma))
    return k / torch.sum(k)


def _symmetric_index(n: int, radius: int, device=None) -> torch.Tensor:
    """Indices of numpy's 'symmetric' padding of a length-n axis by radius."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def gaussian_blur_video(video: torch.Tensor, sigma: float = 3.0, truncate: float = 3.0):
    """Gaussian-blur each frame of a [T, H, W] video (any float scale).

    ``truncate``: kernel support in standard deviations (radius =
    int(truncate * sigma + 0.5), scipy's convention).
    """
    video = video.to(torch.float32)
    t, h, w = video.shape
    radius = int(truncate * float(sigma) + 0.5)
    k = _gauss_kernel1d(float(sigma), radius, video.device)
    x = video[:, None]  # [T 1 H W]
    x = x.index_select(2, _symmetric_index(h, radius, video.device))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = x.index_select(3, _symmetric_index(w, radius, video.device))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x[:, 0]
