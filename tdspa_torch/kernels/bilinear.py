"""Bilinear sampling of per-frame grids: CUDA kernel wrapper + its plain version.

Replaces the TPU kernel ``tdspa/kernels/bilinear.py::bilinear_sample_pallas``
(body ``_bilinear_frame_kernel``): a grid [T, H, W, C] sampled at [N, T, 2]
(x, y) positions, four corners per point, interpolation weights from the
unclamped floor and each corner clamped to the grid on its own (the
reference rule: points outside the grid take edge values with out-of-range
weights). ``tdspa_torch/csrc/bilinear.cu`` computes the plain gather's f32
arithmetic in its order and without contraction, so the two agree bit for
bit.

``bilinear_sample`` launches the kernel for CUDA tensors and runs
``bilinear_sample_reference`` for CPU tensors, through the custom op
``tdspa::bilinear_sample`` (``kernels/ops.py``); it never falls back from one
to the other. The kernel is forward-only: on CUDA tensors that autograd
records the wrapper raises (a kernel's output has no ``grad_fn``).
``bilinear_sample.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from tdspa_torch.kernels import build
from tdspa_torch.kernels.build import forward_only, on_cuda, records


def bilinear_sample_reference(grid, coords, out_dtype=None):
    """Plain gather: grid [T, H, W, C] at coords [N, T, 2] -> [N, T, C].

    The products and sums are f32 for an f32 or bf16 grid (torch's type
    promotion with the f32 weights), then cast to ``out_dtype`` (the
    promoted dtype when None).
    """
    height, width = grid.shape[1], grid.shape[2]
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx = (x - x0f)[..., None]
    wy = (y - y0f)[..., None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, width - 1), (xi + 1).clamp(0, width - 1)
    y0, y1 = yi.clamp(0, height - 1), (yi + 1).clamp(0, height - 1)

    t_idx = torch.arange(grid.shape[0], device=grid.device)[None, :]  # [1 T]
    g00 = grid[t_idx, y0, x0]
    g01 = grid[t_idx, y0, x1]
    g10 = grid[t_idx, y1, x0]
    g11 = grid[t_idx, y1, x1]
    out = (
        g00 * (1 - wx) * (1 - wy)
        + g01 * wx * (1 - wy)
        + g10 * (1 - wx) * wy
        + g11 * wx * wy
    )
    return out if out_dtype is None else out.to(out_dtype)


def bilinear_sample(grid, coords, out_dtype=None):
    """grid [T, H, W, C] sampled at coords [N, T, 2] (x, y) -> [N, T, C].

    ``out_dtype`` defaults to the grid's dtype, as the TPU kernel writes.
    Runs the custom op ``tdspa::bilinear_sample`` (``kernels/ops.py``). CUDA
    tensors launch the kernel, which takes an f32 or bf16 grid, f32
    coordinates and an f32 or bf16 output, and is forward-only; anything
    else raises. CPU tensors run ``bilinear_sample_reference`` (directly,
    and differentiably, where autograd records).
    """
    from tdspa_torch.kernels import ops

    out_dtype = grid.dtype if out_dtype is None else out_dtype
    if grid.dim() != 4 or coords.dim() != 3 or coords.shape[-1] != 2 \
            or coords.shape[1] != grid.shape[0]:
        raise ValueError(f"expected grid [T,H,W,C] and coords [N,T,2]; got {tuple(grid.shape)}, "
                         f"{tuple(coords.shape)}")
    if not on_cuda("bilinear_sample", grid, coords):
        if records(grid, coords):
            return bilinear_sample_reference(grid, coords, out_dtype)
        return ops.bilinear_sample(grid, coords, out_dtype)
    if grid.dtype not in (torch.float32, torch.bfloat16) or coords.dtype != torch.float32 \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes an f32/bf16 grid, f32 coords and an f32/bf16 output; "
                        f"got {grid.dtype}, {coords.dtype}, {out_dtype}")
    forward_only("bilinear_sample", grid, coords)
    return ops.bilinear_sample(grid, coords, out_dtype)


def launch(grid, coords, out_dtype):
    """The kernel's launch on checked CUDA operands (the op's CUDA implementation)."""
    frames, height, width, channels = grid.shape
    n = coords.shape[0]
    grid, coords = grid.contiguous(), coords.contiguous()
    out = torch.empty((n, frames, channels), dtype=out_dtype, device=grid.device)
    if out.numel() == 0:
        return out
    build.launch("tdspa_bilinear_sample", grid.device, grid.data_ptr(), coords.data_ptr(),
                 out.data_ptr(), int(grid.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), frames, height, width, channels, n)
    bilinear_sample.launches += 1
    return out


bilinear_sample.launches = 0
