"""Pyramidal Lucas-Kanade point tracking on tensors (port of ``tdspa/ops/lk.py``).

This is the plain version of the LK kernel (``tdspa_torch/csrc/lk.cu``,
wrapped by ``tdspa_torch.kernels.lk.track_video_lk_kernel``): the same
arithmetic, batched over points with tensor gathers and a Python loop over
frame pairs. Per pair and point:

* coarse-to-fine Gauss-Newton over the pyramid (2x2-mean levels), seeded by
  the previous pair's displacement (constant-velocity prior, clipped to
  +-32 px), with the 2x2 normal matrix solved in closed form;
* optionally a frame-0 cost-volume re-localisation (``corr_radius``) at the
  fine level and at a coarse rescue level, each candidate polished by
  Gauss-Newton and verified by the template NCC;
* visibility = in bounds, a well-conditioned normal matrix, and the optional
  forward-backward, step-NCC and template-NCC checks (centre-weighted NCC).

Bilinear samples clamp each corner to the frame as ``tdspa/ops/lk.py`` does.
Beyond the JAX function it takes the TPU entry's chunking arguments
(``template_frame``, ``template_pos``, ``init_velocity``,
``return_velocity``; ``tdspa/kernels/lk.py::track_video_lk_pallas``), which
change nothing when left at their defaults.
"""

from __future__ import annotations

import torch


def to_gray(video: torch.Tensor) -> torch.Tensor:
    """[T H W 3] (or pre-gray [T H W]) -> [T H W] f32 in [0, 1]."""
    v = video.to(torch.float32) / 255.0
    if v.dim() == 3:  # already luma (the stabilised and denoised re-tracks)
        return v
    return v[..., 0] * 0.299 + v[..., 1] * 0.587 + v[..., 2] * 0.114


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """[T H W] -> [T H/2 W/2], 2x2 mean."""
    t, h, w = img.shape
    return img[:, : h // 2 * 2, : w // 2 * 2].reshape(t, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def build_pyramid(gray: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    pyr = [gray]
    for _ in range(num_levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [H W], coords [... 2] (x, y) -> values [...], each corner clamped."""
    h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, w - 1), (xi + 1).clamp(0, w - 1)
    y0, y1 = yi.clamp(0, h - 1), (yi + 1).clamp(0, h - 1)
    flat = img.reshape(-1)
    return (
        flat[y0 * w + x0] * (1 - wx) * (1 - wy)
        + flat[y0 * w + x1] * wx * (1 - wy)
        + flat[y1 * w + x0] * (1 - wx) * wy
        + flat[y1 * w + x1] * wx * wy
    )


def window_offsets(window: int, device=None) -> torch.Tensor:
    """[K 2] (x, y) offsets of a window x window patch, row-major over y."""
    ax = torch.arange(window, dtype=torch.float32, device=device) - (window - 1) / 2.0
    oy, ox = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def gauss_weights(window: int, device=None) -> torch.Tensor:
    """[K] centre-emphasising weights (sigma = window/4, sum 1)."""
    offs = window_offsets(window, device)
    sigma = window / 4.0
    w = torch.exp(-torch.sum(offs * offs, -1) / (2.0 * sigma * sigma))
    return w / torch.sum(w)


def weighted_ncc(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Centre-weighted NCC of patch rows a, b [..., K] with weights w [K]."""
    am = a - torch.sum(a * w, -1, keepdim=True)
    bm = b - torch.sum(b * w, -1, keepdim=True)
    cov = torch.sum(w * am * bm, -1)
    var = torch.sum(w * am * am, -1) * torch.sum(w * bm * bm, -1)
    return cov / (torch.sqrt(var) + 1e-6)


def lk_level(i0, i1, pts, disp, window: int, iterations: int):
    """One pyramid level of Gauss-Newton LK; returns (disp, min_eig) [N 2], [N]."""
    offs = window_offsets(window, pts.device)
    coords0 = pts[:, None, :] + offs[None]  # [N K 2]
    t_patch = bilinear(i0, coords0)
    half = torch.tensor([0.5, 0.0], device=pts.device)
    ix = bilinear(i0, coords0 + half) - bilinear(i0, coords0 - half)
    iy = bilinear(i0, coords0 + half.flip(0)) - bilinear(i0, coords0 - half.flip(0))
    gxx = torch.sum(ix * ix, -1)
    gxy = torch.sum(ix * iy, -1)
    gyy = torch.sum(iy * iy, -1)
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(torch.clamp(trace**2 - 4 * det, min=0.0))) / 2.0
    inv_det = torch.where(det.abs() > 1e-8, 1.0 / det, torch.zeros_like(det))
    for _ in range(iterations):
        resid = bilinear(i1, coords0 + disp[:, None, :]) - t_patch
        bx = torch.sum(resid * ix, -1)
        by = torch.sum(resid * iy, -1)
        dx = inv_det * (gyy * bx - gxy * by)
        dy = inv_det * (-gxy * bx + gxx * by)
        disp = disp - torch.stack([dx, dy], dim=-1)
    return disp, min_eig


def track_pair(pyr0, pyr1, pts, window: int, iterations: int, init_disp=None):
    """Track pts [N 2] from pyramid pyr0 to pyr1 (fine first); returns
    (new_pts, min_eig at the finest level). ``init_disp`` seeds the coarsest
    level with a full-resolution displacement prior."""
    num_levels = len(pyr0)
    coarse_scale = 2.0 ** (num_levels - 1)
    disp = torch.zeros_like(pts) if init_disp is None else init_disp / coarse_scale
    min_eig = torch.zeros(pts.shape[0], device=pts.device)
    for lvl in reversed(range(num_levels)):
        scale = 2.0**lvl
        disp, min_eig = lk_level(pyr0[lvl], pyr1[lvl], pts / scale, disp, window, iterations)
        if lvl > 0:
            disp = disp * 2.0
    return pts + disp, min_eig


def corr_refine(template_raw, i1, pts1, window: int, radius: int):
    """Frame-0 cost volume: the template's centre-weighted NCC at every
    integer offset of a (2r+1)^2 grid around round-half-up(pts1); returns
    (snapped [N 2], peak [N]), the first maximum winning ties."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=pts1.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    cand = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # [C 2]
    centers = torch.floor(pts1 + 0.5)[:, None, :] + cand[None]  # [N C 2]
    offs = window_offsets(window, pts1.device)
    patches = bilinear(i1, centers[:, :, None, :] + offs[None, None])  # [N C K]
    ncc = weighted_ncc(template_raw[:, None, :], patches, gauss_weights(window, pts1.device))
    peak, best = torch.max(ncc, dim=-1)
    snapped = torch.gather(centers, 1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    return snapped, peak


def track_all(pyramids, queries, template_frame, template_pos, init_velocity, window,
              iterations, fb_threshold, ncc_threshold, template_ncc_threshold,
              corr_radius=0, corr_iterations=2, corr_accept=0.85, corr_rescue_level=0):
    """The frame-pair loop over a prepared pyramid (fine first, [T h w] each).

    Returns (tracks [N T 2], visible [N T] bool, final velocity [N 2]).
    """
    num_levels = len(pyramids)
    t, h, w = pyramids[0].shape
    offs = window_offsets(window, queries.device)
    gauss_w = gauss_weights(window, queries.device)
    template_raw = bilinear(template_frame, template_pos[:, None, :] + offs[None])  # [N K]
    rescue_lvl = min(corr_rescue_level, num_levels - 1)
    if corr_radius > 0 and rescue_lvl > 0:
        rescue_scale = 2.0**rescue_lvl
        tmpl_c = build_pyramid(template_frame[None], rescue_lvl + 1)[rescue_lvl][0]
        template_raw_c = bilinear(tmpl_c, template_pos[:, None, :] / rescue_scale + offs[None])

    pts, vel = queries, init_velocity
    traj, vis = [queries], [torch.ones(queries.shape[0], dtype=torch.bool, device=queries.device)]
    for idx in range(t - 1):
        p0 = [lvl[idx] for lvl in pyramids]
        p1 = [lvl[idx + 1] for lvl in pyramids]
        new_pts, min_eig = track_pair(p0, p1, pts, window, iterations, init_disp=vel)
        if corr_radius > 0:
            def template_score(p):
                return weighted_ncc(template_raw, bilinear(p1[0], p[:, None, :] + offs[None]), gauss_w)

            snapped, _ = corr_refine(template_raw, p1[0], new_pts, window, corr_radius)
            disp, _ = lk_level(p0[0], p1[0], pts, snapped - pts, window, corr_iterations)
            candidates = [pts + disp]
            if rescue_lvl > 0:
                snap_c, _ = corr_refine(template_raw_c, p1[rescue_lvl], new_pts / rescue_scale,
                                        window, corr_radius)
                disp_c, _ = lk_level(p0[0], p1[0], pts, snap_c * rescue_scale - pts, window,
                                     corr_iterations)
                candidates.append(pts + disp_c)
            score_lk = template_score(new_pts)
            best_pts, best_score = new_pts, score_lk
            for cand in candidates:
                s = template_score(cand)
                best_pts = torch.where((s > best_score)[:, None], cand, best_pts)
                best_score = torch.maximum(best_score, s)
            accept = (best_score > corr_accept) & (best_score > score_lk + 0.1)
            new_pts = torch.where(accept[:, None], best_pts, new_pts)
        in_bounds = (
            (new_pts[:, 0] >= 0) & (new_pts[:, 0] <= w - 1)
            & (new_pts[:, 1] >= 0) & (new_pts[:, 1] <= h - 1)
        )
        visible = in_bounds & (min_eig > 1e-6)
        if fb_threshold > -1.0:
            back_pts, _ = track_pair(p1, p0, new_pts, window, iterations, init_disp=pts - new_pts)
            visible &= torch.linalg.norm(back_pts - pts, dim=-1) < fb_threshold
        if ncc_threshold > -1.0:
            a = bilinear(p0[0], pts[:, None, :] + offs[None])
            b = bilinear(p1[0], new_pts[:, None, :] + offs[None])
            visible &= weighted_ncc(a, b, gauss_w) > ncc_threshold
        if template_ncc_threshold > -1.0:
            patch = bilinear(p1[0], new_pts[:, None, :] + offs[None])
            visible &= weighted_ncc(template_raw, patch, gauss_w) > template_ncc_threshold
        clamped = torch.stack(
            [new_pts[:, 0].clamp(0, w - 1), new_pts[:, 1].clamp(0, h - 1)], dim=-1
        )
        vel = torch.clamp(clamped - pts, -32.0, 32.0)
        pts = clamped
        traj.append(clamped)
        vis.append(visible)
    return torch.stack(traj, dim=1), torch.stack(vis, dim=1), vel


def prepare_inputs(video, queries, template_frame, template_pos, init_velocity,
                   fb_threshold: float, input_scale: float):
    """Luma, queries, template and velocity seed at the tracked resolution.

    ``input_scale=0.5`` tracks on the 2x2-mean half-resolution luma: a
    half-res pixel centre i sits at full-res 2i + 0.5, so positions map as
    (x - 0.5) / 2 and velocities halve; ``fb_threshold`` is given in
    full-res pixels and halves too.
    """
    if input_scale not in (1.0, 0.5):
        raise ValueError(f"input_scale must be 1.0 or 0.5, got {input_scale}")
    gray = to_gray(video)
    dev = gray.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    template_pos = (
        queries if template_pos is None
        else torch.as_tensor(template_pos, dtype=torch.float32, device=dev)
    )
    init_velocity = (
        torch.zeros_like(queries) if init_velocity is None
        else torch.as_tensor(init_velocity, dtype=torch.float32, device=dev)
    )
    template_frame = (
        None if template_frame is None
        else torch.as_tensor(template_frame, dtype=torch.float32, device=dev)
    )
    if input_scale == 0.5:
        gray = downsample2(gray)
        queries = (queries - 0.5) * 0.5
        template_pos = (template_pos - 0.5) * 0.5
        if template_frame is not None:
            template_frame = downsample2(template_frame[None])[0]
        init_velocity = init_velocity * 0.5
        fb_threshold = float(fb_threshold) * 0.5
    if template_frame is None:
        template_frame = gray[0]
    return gray, queries, template_frame, template_pos, init_velocity, float(fb_threshold)


def finish_outputs(tracks, visible, vel, input_scale: float, return_velocity: bool):
    """Back to full-resolution pixels; visible as f32 [N T 1]."""
    if input_scale == 0.5:
        tracks = tracks * 2.0 + 0.5
        vel = vel * 2.0
    out = (tracks, visible.to(torch.float32)[..., None])
    return out + (vel,) if return_velocity else out


def track_video_lk(
    video,
    queries,  # [N 2] (x, y) positions at frame 0
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
    input_scale: float = 1.0,
    template_frame=None,  # [H W] f32 gray in [0, 1]; default: this video's frame 0
    template_pos=None,  # [N 2]; default: queries
    init_velocity=None,  # [N 2] velocity-prior seed; default zeros
    return_velocity: bool = False,
):
    """Track query points through a video ([T H W 3] or luma [T H W], 0-255).

    Returns (tracks [N T 2] f32, visible [N T 1] f32) and, with
    ``return_velocity``, the final velocity [N 2], all in full-resolution
    pixels. Arguments as in ``tdspa.ops.lk.track_video_lk``.
    """
    gray, queries, template_frame, template_pos, init_velocity, fb_threshold = prepare_inputs(
        video, queries, template_frame, template_pos, init_velocity, fb_threshold, input_scale
    )
    tracks, visible, vel = track_all(
        build_pyramid(gray, num_levels), queries, template_frame, template_pos, init_velocity,
        window, iterations, fb_threshold, float(ncc_threshold), float(template_ncc_threshold),
        int(corr_radius), int(corr_iterations), float(corr_accept), int(corr_rescue_level),
    )
    return finish_outputs(tracks, visible, vel, input_scale, return_velocity)
