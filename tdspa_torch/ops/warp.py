"""Global-motion (similarity) estimation and video warping (port of
``tdspa/ops/warp.py``): the tracker's roll-stabilise tier.

* ``fit_similarity_sequence``: per-frame global similarity from tracks, a
  complex least squares z_t ~ w z_{t-1} + b written in real pairs, with
  annealed hard inlier reweighting, composed frame to frame. The tracker's
  ``auto`` gate runs it on every call.
* ``warp_video_similarity``: counter-warps luma into the frame-0
  orientation with the JAX package's arithmetic: scale and translation by a
  separable linear resampling (``jax.image.scale_and_translate`` with
  ``method='linear'``, ``antialias=False``, written out as two weight
  matrices), rotation by three Paeth shear passes of 8-row blocks with
  8-tap hat weights, angle-halved, on an edge-padded canvas.
"""

from __future__ import annotations

import numpy as np
import torch

_TAPS = 8
_BLOCK = 8


def fit_similarity_sequence(tracks, rounds: int = 3, inlier_px: float = 2.0,
                            min_inliers: int = 4) -> dict:
    """tracks [N T 2] -> dict of A [T 2 2], t [T 2] (frame 0 -> frame t:
    p_t = A p_0 + t), angle_deg [T], scale [T], inlier_frac [T]."""
    tracks = tracks.to(torch.float32)
    n = tracks.shape[0]
    x0, y0 = tracks[:, :-1, 0], tracks[:, :-1, 1]  # [N T-1]
    x1, y1 = tracks[:, 1:, 0], tracks[:, 1:, 1]
    w = torch.ones_like(x0)
    anneal = [inlier_px * 2.0 ** (rounds - 1 - r) for r in range(rounds)]
    for thr in anneal:
        ws = w.sum(0) + 1e-8
        mx0, my0 = (w * x0).sum(0) / ws, (w * y0).sum(0) / ws
        mx1, my1 = (w * x1).sum(0) / ws, (w * y1).sum(0) / ws
        cx0, cy0 = x0 - mx0, y0 - my0
        cx1, cy1 = x1 - mx1, y1 - my1
        num_r = (w * (cx0 * cx1 + cy0 * cy1)).sum(0)
        num_i = (w * (cx0 * cy1 - cy0 * cx1)).sum(0)
        den = (w * (cx0 * cx0 + cy0 * cy0)).sum(0) + 1e-8
        wr, wi = num_r / den, num_i / den
        bx = mx1 - (wr * mx0 - wi * my0)
        by = my1 - (wi * mx0 + wr * my0)
        resid = torch.hypot(x1 - (wr * x0 - wi * y0 + bx), y1 - (wi * x0 + wr * y0 + by))
        w_new = (resid < thr).to(torch.float32)
        keep = w_new.sum(0) >= min_inliers
        w = torch.where(keep[None, :], w_new, w)
    inliers = ((resid < inlier_px).to(torch.float32) * w).sum(0)
    ok = inliers >= min_inliers
    one, zero = torch.ones_like(wr), torch.zeros_like(wr)
    steps = torch.stack([torch.where(ok, wr, one), torch.where(ok, wi, zero),
                         torch.where(ok, bx, zero), torch.where(ok, by, zero)], dim=-1).cpu()
    # Compose frame to frame (a short sequential scan: on the host).
    pwr, pwi, pbx, pby = (torch.tensor(v, dtype=torch.float32) for v in (1.0, 0.0, 0.0, 0.0))
    composed = [torch.stack([pwr, pwi, pbx, pby])]
    for swr, swi, sbx, sby in steps:
        pwr, pwi, pbx, pby = (
            swr * pwr - swi * pwi,
            swr * pwi + swi * pwr,
            swr * pbx - swi * pby + sbx,
            swi * pbx + swr * pby + sby,
        )
        composed.append(torch.stack([pwr, pwi, pbx, pby]))
    cwr, cwi, cbx, cby = torch.stack(composed).to(tracks.device).unbind(-1)
    a_mat = torch.stack([torch.stack([cwr, -cwi], -1), torch.stack([cwi, cwr], -1)], -2)
    return {
        "A": a_mat,
        "t": torch.stack([cbx, cby], -1),
        "angle_deg": torch.rad2deg(torch.atan2(cwi, cwr)),
        "scale": torch.hypot(cwr, cwi),
        "inlier_frac": torch.cat([torch.ones(1, device=tracks.device), inliers / float(max(n, 1))]),
    }


def apply_similarity(a_mat, t_vec, pos):
    """p_t = A_t p + t_t for pos [N T 2] (stabilised -> original coords)."""
    return torch.einsum("tij,ntj->nti", a_mat, pos) + t_vec[None]


def _shear_x_pass(frames, alpha, beta):
    """out[t, y, x] = in[t, y, x + alpha_t * (y - cy) + beta_t] (edge padded):
    per 8-row block one slice at the block's integer base shift, and 8
    hat-weighted taps for each row's residual."""
    t, h, w = frames.shape
    cy = (h - 1) / 2.0
    nb = h // _BLOCK
    pad = int(np.ceil(0.708 * cy)) + _TAPS + 2
    padded = torch.cat(
        [frames[:, :, :1].expand(t, h, pad), frames, frames[:, :, -1:].expand(t, h, pad)], dim=2
    )
    ys = torch.arange(h, dtype=torch.float32, device=frames.device) - cy
    shift = alpha[:, None] * ys[None, :] + beta[:, None]  # [T H]
    blk = shift.reshape(t, nb, _BLOCK)
    base = torch.floor(torch.amin(blk, dim=2)).to(torch.int64)  # [T nb]
    resid = blk - base[..., None].to(torch.float32)  # [T nb 8]
    tap = torch.arange(_TAPS, dtype=torch.float32, device=frames.device)
    wts = torch.clamp(1.0 - torch.abs(resid[..., None] - tap), min=0.0)  # [T nb 8 taps]
    # lax.dynamic_slice clamps the start so that the slice stays in bounds.
    start = torch.clamp(pad + base, 0, padded.shape[2] - (w + _TAPS))  # [T nb]
    rows = padded.reshape(t, nb, _BLOCK, padded.shape[2])
    cols = start[..., None, None] + torch.arange(w, device=frames.device)  # [T nb 1 w]
    out = torch.zeros((t, nb, _BLOCK, w), dtype=frames.dtype, device=frames.device)
    for m in range(_TAPS):
        sl = torch.gather(rows, 3, (cols + m).expand(t, nb, _BLOCK, w))
        out = out + wts[..., m : m + 1] * sl
    return out.reshape(t, nb * _BLOCK, w)


def _shear_y_pass(frames, alpha, beta):
    """out[t, y, x] = in[t, y + alpha_t * (x - cx) + beta_t, x]."""
    return _shear_x_pass(frames.transpose(1, 2), alpha, beta).transpose(1, 2)


def _paeth_rotate(frames, theta):
    """Backward-rotate each frame about its centre by theta_t: three shears."""
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    z = torch.zeros_like(theta)
    out = _shear_x_pass(frames, a, z)
    out = _shear_y_pass(out, b, z)
    return _shear_x_pass(out, a, z)


def _linear_weight_mat(input_size: int, output_size: int, scale, translation):
    """jax.image's linear resampling weights [T in out] for per-frame scale
    and translation [T] (antialias off)."""
    inv_scale = 1.0 / scale[:, None]
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=scale.device) + 0.5)
                * inv_scale - translation[:, None] * inv_scale - 0.5)  # [T out]
    grid_in = torch.arange(input_size, dtype=torch.float32, device=scale.device)
    x = torch.abs(sample_f[:, None, :] - grid_in[None, :, None])  # [T in out]
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=1, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def warp_video_similarity(video_gray, a_mat, t_vec):
    """Stabilise: out_t(p) = in_t(A_t p + t_t) for a similarity (A = s R).

    video_gray [T H W] (H, W multiples of 8); a_mat [T 2 2]; t_vec [T 2].
    Rotations are accurate up to a cumulative 100 degrees (past it the fixed
    shear pad is exceeded; the tracker's gate, STAB_MAX_ANGLE_DEG, holds it).
    """
    t, h, w = video_gray.shape
    frames = video_gray.to(torch.float32)
    pad = int(-(-0.3 * max(h, w) // _BLOCK) * _BLOCK)
    frames = torch.nn.functional.pad(frames[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]
    pad_vec = torch.tensor([pad, pad], dtype=torch.float32, device=frames.device)
    t_vec = t_vec + pad_vec - torch.einsum("tij,j->ti", a_mat, pad_vec)
    t, h, w = frames.shape
    theta = torch.atan2(a_mat[:, 1, 0], a_mat[:, 0, 0])
    s = torch.sqrt(torch.clamp(torch.linalg.det(a_mat), min=1e-12))
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ctr = torch.tensor([cx, cy], dtype=torch.float32, device=frames.device)
    rot = torch.stack(
        [torch.stack([torch.cos(theta), -torch.sin(theta)], -1),
         torch.stack([torch.sin(theta), torch.cos(theta)], -1)], -2,
    )
    shift = torch.einsum("tij,j->ti", rot, ctr) + (t_vec - ctr[None]) / s[:, None]
    off_x = cx * (1.0 - s) + s * shift[:, 0]
    off_y = cy * (1.0 - s) + s * shift[:, 1]
    scale = 1.0 / s
    wy = _linear_weight_mat(h, h, scale, -off_y / s)  # [T H H']
    wx = _linear_weight_mat(w, w, scale, -off_x / s)  # [T W W']
    mid = wy.transpose(1, 2) @ frames @ wx
    out = _paeth_rotate(_paeth_rotate(mid, theta / 2.0), theta / 2.0)
    return out[:, pad:-pad, pad:-pad]

