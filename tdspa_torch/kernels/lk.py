"""Pyramidal LK tracking: CUDA kernel wrapper (plain version in ``ops/lk.py``).

Replaces the TPU kernel ``tdspa/kernels/lk.py::track_video_lk_pallas`` with
``tdspa_torch/csrc/lk.cu``: one launch tracks every point through every frame
pair of the call (one warp per point, the frame-pair loop inside the kernel;
a window whose corners all lie inside the level is read with no clamps).
``track_video_lk_kernel`` has the TPU entry's contract: the chunking
arguments (``template_frame``, ``template_pos``, ``init_velocity``,
``return_velocity``) and ``input_scale`` 0.5 handled here, around the
kernel, as the TPU wrapper does.

The kernel computes ``tdspa/ops/lk.py``'s arithmetic, which the TPU kernel
approximates at borders, and drops the TPU kernel's Mosaic limits (the cap
on levels for frames under 128 pixels, point padding to 8, ``narrow``, the
span <= 16 limit). So at ``input_scale=0.5`` on 512x512 frames it keeps the
3 levels that ``ops/lk.py`` keeps where the TPU kernel drops to 2.

For CPU tensors the wrapper runs the plain version
(``tdspa_torch.ops.lk.track_video_lk``); for CUDA tensors it launches the
kernel or raises. ``track_video_lk_kernel.launches`` counts launches, and
``track_video_lk_kernel.cost_volume_launches`` those of them with the cost
volume on (``corr_radius`` > 0, the rescue tier's configuration).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tdspa_torch.kernels import build
from tdspa_torch.ops import lk as plain

MAX_WINDOW = 11  # csrc/lk.cu: window^2 <= 121 pixels, at most 4 per lane
MAX_LEVELS = 8

# tdspa_lk_track(level_ptrs, level_h, level_w, levels, tmpl0, tmpl_rescue, h_r, w_r,
#                queries, tpos, init_vel, gauss_w, tracks, vis, vel_out, N, T, window,
#                iterations, fb, ncc, tncc, corr_radius, corr_iterations, corr_accept,
#                rescue_level, stream) in csrc/lk.cu.
ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


@functools.cache
def _kernel():
    fn = build.load("lk").tdspa_lk_track
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def track_video_lk_kernel(
    video,  # [T H W 3] uint8/float or luma [T H W], 0-255
    queries,  # [N 2] f32 (x, y) at frame 0
    num_levels: int = 3,
    window: int = 7,
    iterations: int = 4,
    fb_threshold: float = 2.0,
    ncc_threshold: float = 0.7,
    template_ncc_threshold: float = 0.5,
    corr_radius: int = 0,
    corr_iterations: int = 2,
    corr_accept: float = 0.85,
    corr_rescue_level: int = 0,
    template_frame=None,  # [H W] f32 gray in [0, 1]; default: this video's frame 0
    template_pos=None,  # [N 2]; default: queries
    init_velocity=None,  # [N 2] velocity-prior seed; default zeros
    input_scale: float = 1.0,
    return_velocity: bool = False,
):
    """Track query points through a video; the contract of
    ``tdspa.kernels.lk.track_video_lk_pallas``.

    Returns (tracks [N T 2] f32, visible [N T 1] f32) and, with
    ``return_velocity``, the final velocity [N 2], in full-resolution pixels.
    """
    if not isinstance(video, torch.Tensor):
        raise TypeError(f"video must be a torch.Tensor, got {type(video).__name__}")
    kwargs = dict(
        num_levels=num_levels, window=window, iterations=iterations,
        fb_threshold=fb_threshold, ncc_threshold=ncc_threshold,
        template_ncc_threshold=template_ncc_threshold, corr_radius=corr_radius,
        corr_iterations=corr_iterations, corr_accept=corr_accept,
        corr_rescue_level=corr_rescue_level, input_scale=input_scale,
        template_frame=template_frame, template_pos=template_pos,
        init_velocity=init_velocity, return_velocity=return_velocity,
    )
    if video.device.type == "cpu":
        return plain.track_video_lk(video, queries, **kwargs)
    if video.device.type != "cuda":
        raise ValueError(f"unsupported device {video.device}")
    del kwargs["return_velocity"]
    tracks, vis, vel = launch(prepare_launch(video, queries, **kwargs))
    return plain.finish_outputs(tracks, vis, vel, input_scale, return_velocity)


track_video_lk_kernel.launches = 0
track_video_lk_kernel.cost_volume_launches = 0


@dataclasses.dataclass
class LaunchArgs:
    """One launch's device inputs at the tracked resolution."""

    pyramid: list  # [T h w] f32 levels, fine first
    template: torch.Tensor  # [h w] f32
    template_rescue: torch.Tensor  # [h_r w_r] f32 (the template when unused)
    queries: torch.Tensor  # [N 2]
    template_pos: torch.Tensor  # [N 2]
    init_velocity: torch.Tensor  # [N 2]
    gauss_w: torch.Tensor  # [window^2]
    window: int
    iterations: int
    fb_threshold: float
    ncc_threshold: float
    template_ncc_threshold: float
    corr_radius: int
    corr_iterations: int
    corr_accept: float
    rescue_level: int


def prepare_launch(video, queries, num_levels=3, window=7, iterations=4, fb_threshold=2.0,
                   ncc_threshold=0.7, template_ncc_threshold=0.5, corr_radius=0,
                   corr_iterations=2, corr_accept=0.85, corr_rescue_level=0,
                   template_frame=None, template_pos=None, init_velocity=None,
                   input_scale=1.0) -> LaunchArgs:
    """Checks the arguments and builds the kernel's inputs on the video's
    CUDA device: luma, its pyramid, the template frame and its rescue level."""
    if not 1 <= window <= MAX_WINDOW or not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(
            f"kernel takes window 1..{MAX_WINDOW} and 1..{MAX_LEVELS} levels, "
            f"got window={window}, num_levels={num_levels}"
        )
    if iterations < 0 or corr_radius < 0 or corr_iterations < 0 or corr_rescue_level < 0:
        raise ValueError("iterations, corr_radius, corr_iterations and corr_rescue_level must be >= 0")
    gray, q, tframe, tpos, vel0, fb = plain.prepare_inputs(
        video, queries, template_frame, template_pos, init_velocity, fb_threshold, input_scale
    )
    n = q.shape[0]
    if q.shape != (n, 2) or tpos.shape != (n, 2) or vel0.shape != (n, 2):
        raise ValueError(
            f"queries, template_pos and init_velocity must be [N, 2]; got "
            f"{tuple(q.shape)}, {tuple(tpos.shape)}, {tuple(vel0.shape)}"
        )
    if tframe.shape != gray.shape[1:]:
        raise ValueError(f"template_frame {tuple(tframe.shape)} != frame {tuple(gray.shape[1:])}")
    pyramid = [p.contiguous() for p in plain.build_pyramid(gray, num_levels)]
    if min(min(p.shape[1:]) for p in pyramid) < 1:
        raise ValueError(f"frames {tuple(gray.shape[1:])} too small for {num_levels} levels")
    rescue_level = min(corr_rescue_level, num_levels - 1) if corr_radius > 0 else 0
    tframe = tframe.contiguous()
    tmpl_rescue = (
        plain.build_pyramid(tframe[None], rescue_level + 1)[rescue_level][0].contiguous()
        if rescue_level > 0 else tframe
    )
    return LaunchArgs(
        pyramid, tframe, tmpl_rescue, q.contiguous(), tpos.contiguous(), vel0.contiguous(),
        plain.gauss_weights(window, gray.device).contiguous(), window, iterations, fb,
        float(ncc_threshold), float(template_ncc_threshold), int(corr_radius),
        int(corr_iterations), float(corr_accept), rescue_level,
    )


def launch(a: LaunchArgs):
    """One kernel launch on the current stream -> (tracks [N T 2], visible
    [N T] 0/1, final velocity [N 2]) at the tracked resolution."""
    dev = a.queries.device
    n, num_frames = a.queries.shape[0], a.pyramid[0].shape[0]
    tracks = torch.empty((n, num_frames, 2), dtype=torch.float32, device=dev)
    vis = torch.empty((n, num_frames), dtype=torch.float32, device=dev)
    vel = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return tracks, vis, vel
    level_ptrs = np.array([p.data_ptr() for p in a.pyramid], np.uint64)
    level_h = np.array([p.shape[1] for p in a.pyramid], np.int32)
    level_w = np.array([p.shape[2] for p in a.pyramid], np.int32)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            level_ptrs.ctypes.data, level_h.ctypes.data, level_w.ctypes.data, len(a.pyramid),
            a.template.data_ptr(), a.template_rescue.data_ptr(), a.template_rescue.shape[0],
            a.template_rescue.shape[1], a.queries.data_ptr(), a.template_pos.data_ptr(),
            a.init_velocity.data_ptr(), a.gauss_w.data_ptr(), tracks.data_ptr(), vis.data_ptr(),
            vel.data_ptr(), n, num_frames, a.window, a.iterations, a.fb_threshold,
            a.ncc_threshold, a.template_ncc_threshold, a.corr_radius, a.corr_iterations,
            a.corr_accept, a.rescue_level, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"LK kernel launch failed: CUDA error {rc}")
    track_video_lk_kernel.launches += 1
    if a.corr_radius > 0:
        track_video_lk_kernel.cost_volume_launches += 1
    return tracks, vis, vel
