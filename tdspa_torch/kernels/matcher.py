"""Matcher cost patches: CUDA kernel wrapper + plain version.

Replaces the TPU kernel ``tdspa/kernels/matcher.py::cost_patches_multi_pallas``
(and ``cost_patches_pallas``, its one-template case) with
``tdspa_torch/csrc/matcher.cu``: the (2R+1)^2 correlations between each
point's template vectors and the feature map sampled bilinearly around the
point's position in every frame. It computes the XLA path of the matcher
(``tdspa/features/matcher.py::_cost_patches_multi``), whose border corners
clamp one by one; the TPU kernel shifts border windows inward instead. The
kernel contracts each clamped window pixel with the templates first and
blends the four products of each offset after (``tests/test_torch_matcher.py``
models that order and its window in torch); the plain version blends
channels, then contracts.

``cost_patches_multi`` launches the kernel for CUDA tensors and runs
``cost_patches_reference`` for CPU tensors; it never falls back from one to
the other. ``cost_patches_multi.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import forward_only, on_cuda
from tdspa_torch.kernels.bilinear import bilinear_sample_reference

DIMS = (8, 16, 32)  # feature widths the kernel is built for
MAX_RADIUS = 8  # csrc/matcher.cu: a block's window products fit 48 KB of shared memory


def offset_grid(radius: int, device=None) -> torch.Tensor:
    """[(2R+1)^2, 2] (x, y) integer offsets, row-major over y."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def cost_patches_reference(feats, template_vecs, positions, radius: int = 4):
    """Plain version: feats [T Hf Wf D], template_vecs [N M D], positions
    [N T 2] in FEATURE pixels -> costs [N T M (2R+1)^2]."""
    n, t = positions.shape[:2]
    offs = offset_grid(radius, positions.device)  # [K2 2]
    k2 = offs.shape[0]
    coords = positions[:, None, :, :] + offs[:, None, :]  # [N K2 T 2]
    patch = bilinear_sample_reference(feats, coords.reshape(n * k2, t, 2)).reshape(n, k2, t, -1)
    return torch.einsum("nktd,nmd->ntmk", patch, template_vecs)


def cost_patches_multi(feats, template_vecs, positions, radius: int = 4):
    """Template-bank cost patches: [T Hf Wf D] feats, [N M D] templates,
    [N T 2] feature-pixel positions -> [N T M (2R+1)^2] f32.

    CUDA tensors launch the Hopper kernel, which takes f32 with D in
    ``DIMS`` and ``radius <= MAX_RADIUS`` and is forward-only (autograd
    recording through it raises); anything else raises. CPU tensors run
    ``cost_patches_reference``, which is differentiable.
    """
    if feats.dim() != 4 or template_vecs.dim() != 3 or positions.dim() != 3:
        raise ValueError(
            f"expected feats [T,Hf,Wf,D], template_vecs [N,M,D], positions [N,T,2]; got "
            f"{tuple(feats.shape)}, {tuple(template_vecs.shape)}, {tuple(positions.shape)}"
        )
    t, hf, wf, dim = feats.shape
    n, m = template_vecs.shape[:2]
    if template_vecs.shape[2] != dim or positions.shape != (n, t, 2):
        raise ValueError(
            f"template_vecs {tuple(template_vecs.shape)} and positions "
            f"{tuple(positions.shape)} do not fit feats {tuple(feats.shape)}"
        )
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    if not on_cuda("cost_patches_multi", feats, template_vecs, positions):
        return cost_patches_reference(feats, template_vecs, positions, radius)
    if any(x.dtype != torch.float32 for x in (feats, template_vecs, positions)):
        raise TypeError("kernel takes f32 feats, template_vecs and positions")
    if dim not in DIMS:
        raise ValueError(f"kernel takes feature width D in {DIMS}, got {dim}")
    if radius > MAX_RADIUS:
        raise ValueError(f"kernel takes radius <= {MAX_RADIUS}, got {radius}")
    forward_only("cost_patches_multi", feats, template_vecs, positions)
    feats, template_vecs, positions = (
        x.contiguous() for x in (feats, template_vecs, positions)
    )
    if feats.data_ptr() % 16 or template_vecs.data_ptr() % 16:
        raise ValueError("kernel takes 16-byte aligned feats and template_vecs")
    if positions.data_ptr() % 8:
        raise ValueError("kernel takes 8-byte aligned positions")
    k2 = (2 * radius + 1) ** 2
    out = torch.empty((n, t, m, k2), dtype=torch.float32, device=feats.device)
    if out.numel() == 0 or hf * wf == 0:
        return out
    build.launch("tdspa_cost_patches", feats.device, feats.data_ptr(), template_vecs.data_ptr(),
                 positions.data_ptr(), out.data_ptr(), n, t, hf, wf, dim, m, radius)
    cost_patches_multi.launches += 1
    return out


cost_patches_multi.launches = 0
