"""Geometry / sampling ops (port of ``tdspa/ops/geometry.py``):
``bilinear_sample``, ``lift_2d_to_3d`` and the DINO / depth feature
samplers of the inference tail, and the visualizer's projections
``project_3d_to_2d`` / ``project_all_tracks``.

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


def _transform(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """``mat [..., I, J]`` applied to ``vec [..., N, J]`` -> ``[..., N, I]``:
    the products summed over j in order, as separate elementwise ops, so the
    CPU and a GPU round alike (a matmul would reduce in the library's order)."""
    out = mat[..., None, :, 0] * vec[..., 0:1]
    for j in range(1, mat.shape[-1]):
        out = out + mat[..., None, :, j] * vec[..., j : j + 1]
    return out


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    device = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def project_3d_to_2d(coords_3d, intrinsics, extrinsics):
    """Project [N 3] world points to 2D via [4 4] extrinsics + [3 3] intrinsics.

    Returns (coords_2d [N 2], depths [N]), f32, NaN/inf replaced with 0
    (reference visualize.py:15-44). The perspective divide adds 1e-8 like the
    reference.
    """
    coords_3d = _f32(coords_3d)
    homo = torch.cat([coords_3d, torch.ones_like(coords_3d[..., :1])], dim=-1)  # [N 4]
    cam = _transform(_f32(extrinsics, coords_3d), homo)  # [N 4]
    depths = cam[..., 2]
    proj = _transform(_f32(intrinsics, coords_3d), cam[..., :3])  # [N 3]
    coords_2d = proj[..., :2] / (proj[..., 2:3] + 1e-8)
    coords_2d = torch.nan_to_num(coords_2d, nan=0.0, posinf=0.0, neginf=0.0)
    depths = torch.nan_to_num(depths, nan=0.0, posinf=0.0, neginf=0.0)
    return coords_2d, depths


def project_all_tracks(coords_3d, intrinsics, extrinsics, resize_height: int = 1024,
                       resize_width: int = 1024, original_height: int | None = None,
                       original_width: int | None = None) -> torch.Tensor:
    """Project [T N 3] tracks for all frames with resize-scaled intrinsics.

    Mirrors reference visualize.py:125-175: fx/cx scaled by
    resize_width/original_width (fy/cy by the height ratio), projected,
    scaled back, clipped to the original image bounds. Intrinsics [3 3] or
    [T 3 3], extrinsics [4 4] or [T 4 4]; arrays or tensors, computed in f32
    on ``coords_3d``'s device. Returns float[N T 2].
    """
    coords_3d = _f32(coords_3d)
    num_frames = coords_3d.shape[0]
    intrinsics = _f32(intrinsics, coords_3d).expand(num_frames, 3, 3)
    extrinsics = _f32(extrinsics, coords_3d).expand(num_frames, 4, 4)
    original_height = 512 if original_height is None else original_height
    original_width = 512 if original_width is None else original_width
    scale_x = resize_width / original_width
    scale_y = resize_height / original_height

    scale_mat = _f32([[scale_x, 1.0, scale_x], [1.0, scale_y, scale_y], [1.0, 1.0, 1.0]],
                     coords_3d)
    intr_scaled = intrinsics * scale_mat  # scales the fx, fy, cx, cy entries

    homo = torch.cat([coords_3d, torch.ones_like(coords_3d[..., :1])], dim=-1)  # [T N 4]
    cam = _transform(extrinsics, homo)
    proj = _transform(intr_scaled, cam[..., :3])
    coords_2d = proj[..., :2] / (proj[..., 2:3] + 1e-8)
    coords_2d = torch.nan_to_num(coords_2d, nan=0.0, posinf=0.0, neginf=0.0)

    x = torch.clamp(coords_2d[..., 0] / scale_x, 0, original_width - 1)
    y = torch.clamp(coords_2d[..., 1] / scale_y, 0, original_height - 1)
    return torch.stack([x, y], dim=-1).permute(1, 0, 2)  # [N T 2]
