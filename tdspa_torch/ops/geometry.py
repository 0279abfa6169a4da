"""Geometry / sampling ops of the inference tail (port of
``tdspa/ops/geometry.py``: ``bilinear_sample``, ``lift_2d_to_3d`` and the
DINO / depth feature samplers).

``bilinear_sample`` runs the bilinear kernel (``csrc/bilinear.cu``, the
counterpart of ``tdspa/kernels/bilinear.py``) on CUDA tensors and the plain
gather on CPU tensors; both give the JAX tail's f32 products. Corner rule of
the reference: interpolation weights come from the *unclamped* floor, and
each corner index is clamped to the grid on its own, so points outside the
grid take edge values with out-of-range weights.
"""

from __future__ import annotations

import torch

from tdspa_torch.kernels import bilinear


def bilinear_sample(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid float[T H W C] sampled at coords float[N T 2] (x, y) -> [N T C].

    The result has the dtype of the grid's products with f32 weights (f32
    for an f32 or bf16 grid), as the plain gather gives.
    """
    return bilinear.bilinear_sample(
        grid, coords, out_dtype=torch.promote_types(grid.dtype, coords.dtype)
    )


def lift_2d_to_3d(tracks_2d: torch.Tensor, depth: torch.Tensor, intrinsics=None) -> torch.Tensor:
    """[N T 2] pixel tracks + [T H W 1] depth -> [N T 3] camera coordinates.

    Default intrinsics: fx = fy = max(H, W), cx = W/2, cy = H/2.
    """
    if intrinsics is None:
        height, width = depth.shape[1], depth.shape[2]
        fx = fy = float(max(height, width))
        cx, cy = width / 2.0, height / 2.0
    else:
        fx, fy, cx, cy = intrinsics
    z = bilinear_sample(depth, tracks_2d)[..., 0]
    x, y = tracks_2d[..., 0], tracks_2d[..., 1]
    return torch.stack([(x - cx) * z / fx, (y - cy) * z / fy, z], dim=-1).float()


def sample_dino_features_for_tracks(dino_features, tracks_2d, video_shape):
    """[T Hp Wp D] patch features at [N T 2] image-pixel tracks -> [N T D].

    Pixel coordinates are scaled by ``[Wp/W, Hp/H]`` onto the patch grid.
    """
    if dino_features is None:
        return None
    h_patches, w_patches = dino_features.shape[1], dino_features.shape[2]
    _, height, width = video_shape[:3]
    scale = torch.tensor([w_patches / width, h_patches / height], dtype=torch.float32).to(
        tracks_2d.device)
    return bilinear_sample(dino_features, tracks_2d * scale).float()


def sample_depth_features_for_tracks(depth, tracks_2d, feature_dim: int = 256):
    """Hand-crafted depth features at the tracks: [d, d/10, d_t - d_{t-1}, 0...]."""
    if depth is None:
        return None
    d = bilinear_sample(depth, tracks_2d)[..., 0]  # [N T]
    d_grad = torch.cat([torch.zeros_like(d[..., :1]), d[..., 1:] - d[..., :-1]], dim=-1)
    zeros = torch.zeros(d.shape + (feature_dim - 3,), dtype=d.dtype, device=d.device)
    return torch.cat(
        [d[..., None], (d / 10.0)[..., None], d_grad[..., None], zeros], dim=-1
    ).float()
