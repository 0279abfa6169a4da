"""Synthetic tracking scenes with exact ground-truth tracks and occlusions
(a copy of ``tdspa/utils/synthetic_video.py``; numpy only).

A textured static background plus textured sprites moving with constant
integer velocities in z-order. Every query point is attached to the surface
that is topmost at its position in frame 0; its ground-truth position
follows that surface rigidly and its ground-truth visibility at frame t is
"my surface is the topmost one at my position" (plus in-bounds). Integer
velocities keep the render exact (no resampling), so ground truth is exact
to the pixel. ``chip_smoke.py`` scores the port's tracker on these scenes.
"""

from __future__ import annotations

import numpy as np


def _texture(rng, height, width, cell: int = 4) -> np.ndarray:
    """[H W 3] uint8: piecewise-constant random color cells (strong local
    gradients every ``cell`` pixels — good LK texture, no aliasing)."""
    coarse = rng.integers(30, 226, (height // cell + 1, width // cell + 1, 3))
    return (
        np.repeat(np.repeat(coarse, cell, 0), cell, 1)[:height, :width]
        .astype(np.uint8)
    )


def _natural_texture(rng, height, width) -> np.ndarray:
    """[H W 3] uint8: multi-octave value noise with a ~1/f spectrum.

    Natural images have power-law spatial statistics — smooth large-scale
    gradients with progressively weaker fine detail — unlike the cell
    texture's uniformly strong 4-px edges. This is the photographic-
    statistics stress regime for the tracker's appearance checks and the
    auto-gate thresholds (VERDICT r4 "harden the synthetic benchmark"):
    local contrast varies across the frame, so some windows are
    near-textureless while others are sharp.
    """
    img = np.zeros((height, width, 3), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    amp = 1.0
    for octave in range(6):
        cell = max(4, 128 >> octave)  # 128, 64, 32, 16, 8, 4 px wavelengths
        gh, gw = height // cell + 2, width // cell + 2
        grid = rng.normal(0.0, 1.0, (gh, gw, 3)).astype(np.float32)
        img += amp * _bilinear(grid, xx / cell, yy / cell)
        amp *= 0.55  # ~1/f amplitude ladder
    # Per-channel normalize, then a film-like s-curve (soft shoulders).
    img -= img.mean(axis=(0, 1))
    img /= img.std(axis=(0, 1)) + 1e-6
    img = np.tanh(img * 0.8)
    return np.clip((img * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def _deform_field(shape_xy, t, amp, cycles, period, phases, zoom_rate=0.0,
                  rot_rate=0.0):
    """Smooth displacement D(x, y, t) -> (dx, dy), zero at t = 0.

    Two low-frequency sinusoid components per axis over the frame, scaled
    by sin(2 pi t / period) so frame 0 is undeformed. ``amp * 2 pi *
    cycles / min(H, W) < 1`` keeps the warp a diffeomorphism (the GT
    fixed-point solve then converges and occlusion ordering is preserved).

    ``zoom_rate`` adds a camera zoom about the frame center: scale
    s_t = 1 + zoom_rate * t, expressed as the backward-warp displacement
    D(x) = (1 - 1/s_t)(x - c) — exactly the affine x -> c + s_t (x - c)
    after the fixed-point inversion (linear, converges for s_t > 0.5).

    ``rot_rate`` (radians/frame) adds camera roll about the center:
    D(x) = (x - c) - R(-theta_t)(x - c) — exactly x -> c + R(theta_t)(x - c)
    after inversion (contraction for theta_t < pi/3).
    """
    x, y = shape_xy  # broadcastable arrays of pixel coordinates
    (px1, py1, px2, py2), (w, h) = phases
    temporal = np.sin(2 * np.pi * t / period)
    sx = 2 * np.pi * cycles
    dx = amp * temporal * (
        np.sin(sx * (x / w + 0.6 * y / h) + px1)
        + 0.5 * np.sin(2 * sx * (0.3 * x / w - y / h) + px2)
    )
    dy = amp * temporal * (
        np.sin(sx * (0.7 * y / h - 0.4 * x / w) + py1)
        + 0.5 * np.sin(2 * sx * (x / w + 0.5 * y / h) + py2)
    )
    if zoom_rate:
        s_t = 1.0 + zoom_rate * t
        dx = dx + (1.0 - 1.0 / s_t) * (x - w / 2.0)
        dy = dy + (1.0 - 1.0 / s_t) * (y - h / 2.0)
    if rot_rate:
        th = rot_rate * t
        rx, ry = x - w / 2.0, y - h / 2.0
        # (x-c) - R(-theta)(x-c)
        dx = dx + rx - (np.cos(th) * rx + np.sin(th) * ry)
        dy = dy + ry - (-np.sin(th) * rx + np.cos(th) * ry)
    return dx, dy


def _bilinear(img, x, y):
    """Sample [H W 3] at float coords (clamped); x/y any matching shape."""
    h, w = img.shape[:2]
    x = np.clip(x, 0.0, w - 1.0)
    y = np.clip(y, 0.0, h - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    imgf = img.astype(np.float32)
    top = imgf[y0, x0] * (1 - fx) + imgf[y0, x1] * fx
    bot = imgf[y1, x0] * (1 - fx) + imgf[y1, x1] * fx
    return top * (1 - fy) + bot * fy


# JPEG luminance quantization table (Annex K of the JPEG standard), the
# quality-50 reference point; scaled per the libjpeg quality convention.
_JPEG_Q50 = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.float32,
)


def _jpeg_like(v, quality: int):
    """JPEG-style 8x8 block-DCT quantization, per channel, codec-free.

    v: [T H W 3] f32 in [0, 255]. Produces the blocking/ringing artifact
    family of real compression (no chroma subsampling/entropy stage — those
    don't change the artifact geometry a tracker sees).
    """
    q = int(quality)
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    qtab = np.clip(np.floor((_JPEG_Q50 * scale + 50.0) / 100.0), 1, 255)
    # Orthonormal DCT-II basis.
    k = np.arange(8)
    C = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    C *= np.where(k[:, None] == 0, np.sqrt(1 / 8.0), np.sqrt(2 / 8.0))
    C = C.astype(np.float32)
    t, h, w, c = v.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    pad = np.pad(v, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    # blocks[t, a, i, b, k, c]: block-row a, in-block row i, block-col b,
    # in-block col k. 2D DCT per block: coef = C X C^T.
    blocks = pad.reshape(t, hp // 8, 8, wp // 8, 8, c) - 128.0
    coef = np.einsum("ui,taibkc,vk->taubvc", C, blocks, C, optimize=True)
    qb = qtab[None, None, :, None, :, None]
    coef = np.round(coef / qb) * qb
    rec = np.einsum("ui,taubvc,vk->taibkc", C, coef, C, optimize=True)
    rec = rec.reshape(t, hp, wp, c) + 128.0
    return rec[:, :h, :w]


def make_tracking_scene(
    num_frames: int = 24,
    height: int = 160,
    width: int = 256,
    grid_size: int = 12,
    num_sprites: int = 2,
    sprite_size: int = 48,
    seed: int = 0,
    pan: tuple = (0, 0),
    noise_sigma: float = 0.0,
    contrast: float = 1.0,
    gain_flicker: float = 0.0,
    deform_amp: float = 0.0,
    deform_cycles: float = 1.5,
    deform_period: float = 16.0,
    zoom_rate: float = 0.0,
    rot_rate: float = 0.0,
    jpeg_quality: int = 0,
    motion_blur: int = 0,
    texture: str = "cells",
    camera_gamma: float = 1.0,
):
    """Render a scene and its exact tracking ground truth.

    ``texture``: "cells" (piecewise-constant 4-px color cells — uniformly
    strong LK texture) or "natural" (multi-octave ~1/f value noise — the
    photographic-statistics regime: smooth large-scale gradients, spatially
    varying local contrast, near-textureless patches).
    ``camera_gamma``: != 1 applies a camera response curve
    ``255 * (v/255)^(1/gamma)`` to the final pixels (photometric only —
    compresses highlight/shadow contrast the way real sensor pipelines do;
    GT geometry unchanged).

    ``pan``: integer camera velocity (px/frame). The background renders
    from an oversized texture through a window moving by ``pan`` each
    frame, so background-attached points appear to move by ``-pan`` per
    frame — exact fast-motion ground truth (sprites stay in frame
    coordinates and keep their own velocities).

    Degradations (applied to pixels only — geometry and ground truth are
    unchanged; they create the regimes where brightness-constancy (LK) and
    template-NCC matching degrade and a learned matcher must hold up):
      ``noise_sigma``: per-frame iid Gaussian sensor noise (uint8 scale).
      ``contrast``: global contrast scale about 128 (< 1 = low-texture).
      ``gain_flicker``: per-frame multiplicative exposure swing amplitude
        (frame t is scaled by 1 + a*sin(2 pi t / 8)).
      ``jpeg_quality``: > 0 applies JPEG-style 8x8 block-DCT quantization
        at that quality (1..100, lower = blockier) — codec-free
        compression artifacts. HELD OUT of matcher training and of the
        auto-gate calibration (gate-generalization regime, VERDICT-r3 #6).
      ``motion_blur``: > 0 smears each frame over +/-that many neighbor
        frames (exposure-time blur); also held out.

    Non-rigid deformation (``deform_amp`` > 0, applied to GEOMETRY — the
    composited frame is backward-warped by a smooth analytic displacement
    field and the ground-truth tracks are moved with it): frame t's pixel
    (x, y) shows composite content at (x, y) - D(x, y, t), so content
    moves by ~+D; a point whose rigid composite position is c appears at
    the x solving x - D(x, t) = c, solved here by fixed-point iteration
    (exact to < 1e-4 px — D is a contraction when ``deform_amp *
    2 pi * deform_cycles / min(H, W) < 1``). This is the deforming-content
    regime (CoTracker-class trackers train on it; rigid LK templates and
    frame-0 NCC degrade under it). D(., 0) = 0, so frame-0 queries and
    surface attachment are unchanged. Occlusion ordering is warp-invariant
    (the warp is a diffeomorphism applied to the whole composite).

    Returns:
      video: [T H W 3] uint8.
      tracks: [N T 2] float32 (x, y) — N = grid_size**2 query points laid out
        on a half-pixel-centered grid at frame 0.
      visible: [N T] bool ground-truth visibility.
    """
    rng = np.random.default_rng(seed)
    if texture not in ("cells", "natural"):
        raise ValueError(f"texture must be 'cells' or 'natural', got {texture}")
    make_tex = _texture if texture == "cells" else (
        lambda rng_, h, w, cell=4: _natural_texture(rng_, h, w)
    )
    pan_x, pan_y = int(pan[0]), int(pan[1])
    pad_x, pad_y = abs(pan_x) * (num_frames - 1), abs(pan_y) * (num_frames - 1)
    big_bg = make_tex(rng, height + pad_y, width + pad_x)
    bg_x0 = pad_x if pan_x < 0 else 0
    bg_y0 = pad_y if pan_y < 0 else 0

    def bg_window(t):
        ox = bg_x0 + pan_x * t
        oy = bg_y0 + pan_y * t
        return big_bg[oy : oy + height, ox : ox + width]

    # Sprites: (texture, x0, y0, vx, vy), painted in list order (later on top).
    sprites = []
    for s in range(num_sprites):
        tex = make_tex(rng, sprite_size, sprite_size, cell=4)
        # Start in-frame, velocities +/-{1..3} px/frame, guaranteed nonzero.
        x0 = int(rng.integers(0, width - sprite_size))
        y0 = int(rng.integers(0, height - sprite_size))
        vx = int(rng.choice([-3, -2, -1, 1, 2, 3]))
        vy = int(rng.choice([-2, -1, 1, 2]))
        sprites.append((tex, x0, y0, vx, vy))

    def sprite_origin(s, t):
        tex, x0, y0, vx, vy = sprites[s]
        return x0 + vx * t, y0 + vy * t

    def render(t):
        frame = bg_window(t).copy()
        for s, (tex, *_rest) in enumerate(sprites):
            sx, sy = sprite_origin(s, t)
            x_lo, x_hi = max(sx, 0), min(sx + sprite_size, width)
            y_lo, y_hi = max(sy, 0), min(sy + sprite_size, height)
            if x_lo < x_hi and y_lo < y_hi:
                frame[y_lo:y_hi, x_lo:x_hi] = tex[
                    y_lo - sy : y_hi - sy, x_lo - sx : x_hi - sx
                ]
        return frame

    video = np.stack([render(t) for t in range(num_frames)])

    # Non-rigid / zoom warp of the composite (geometry; before photometrics).
    phases = None
    warp = deform_amp > 0.0 or zoom_rate != 0.0 or rot_rate != 0.0
    if warp:
        phases = (tuple(rng.uniform(0.0, 2 * np.pi, 4)), (width, height))
        ygrid, xgrid = np.mgrid[0:height, 0:width].astype(np.float32)
        warped = []
        for t in range(num_frames):
            dx, dy = _deform_field(
                (xgrid, ygrid), t, deform_amp, deform_cycles,
                deform_period, phases, zoom_rate=zoom_rate,
                rot_rate=rot_rate,
            )
            warped.append(_bilinear(video[t], xgrid - dx, ygrid - dy))
        video = np.clip(np.stack(warped), 0, 255).astype(np.uint8)

    if (
        contrast != 1.0 or noise_sigma > 0.0 or gain_flicker > 0.0
        or jpeg_quality > 0 or motion_blur > 0 or camera_gamma != 1.0
    ):
        v = video.astype(np.float32)
        if motion_blur > 0:
            # Temporal box smear over +/-motion_blur frames (exposure-time
            # blur). Photometric-only approximation: the GT tracks stay the
            # instantaneous mid-exposure geometry, matching how a real
            # tracker is scored on blurred footage.
            k = 2 * motion_blur + 1
            pad = np.concatenate(
                [v[:1]] * motion_blur + [v] + [v[-1:]] * motion_blur, axis=0
            )
            v = np.stack(
                [pad[t : t + k].mean(axis=0) for t in range(num_frames)]
            )
        if contrast != 1.0:
            v = (v - 128.0) * float(contrast) + 128.0
        if gain_flicker > 0.0:
            gains = 1.0 + gain_flicker * np.sin(
                2 * np.pi * np.arange(num_frames) / 8.0
            )
            v = v * gains[:, None, None, None]
        if noise_sigma > 0.0:
            v = v + rng.normal(0.0, noise_sigma, v.shape)
        if jpeg_quality > 0:
            v = _jpeg_like(np.clip(v, 0, 255), jpeg_quality)
        if camera_gamma != 1.0:
            # Sensor/display response: applied last, like a real pipeline
            # (noise passes through the curve with the signal).
            v = 255.0 * np.power(
                np.clip(v, 0, 255) / 255.0, 1.0 / float(camera_gamma)
            )
        video = np.clip(v, 0, 255).astype(np.uint8)

    def topmost_surface(x, y, t):
        """-1 = background, else sprite index (highest wins)."""
        top = -1
        for s in range(len(sprites)):
            sx, sy = sprite_origin(s, t)
            if sx <= x < sx + sprite_size and sy <= y < sy + sprite_size:
                top = s
        return top

    # Query grid at frame 0, each point attached to its topmost surface.
    step_x, step_y = width / grid_size, height / grid_size
    xs = (np.tile(np.arange(grid_size), grid_size) + 0.5) * step_x
    ys = (np.repeat(np.arange(grid_size), grid_size) + 0.5) * step_y
    n = grid_size * grid_size
    tracks = np.zeros((n, num_frames, 2), np.float32)
    visible = np.zeros((n, num_frames), bool)
    for i in range(n):
        owner = topmost_surface(xs[i], ys[i], 0)
        for t in range(num_frames):
            if owner == -1:
                # Camera pans by +pan; world content appears to move -pan.
                px, py = xs[i] - pan_x * t, ys[i] - pan_y * t
            else:
                sx0, sy0 = sprite_origin(owner, 0)
                sxt, syt = sprite_origin(owner, t)
                px, py = xs[i] + (sxt - sx0), ys[i] + (syt - sy0)
            tracks[i, t] = (px, py)
            in_bounds = 0 <= px < width and 0 <= py < height
            visible[i, t] = in_bounds and topmost_surface(px, py, t) == owner

    if warp:
        # Move the GT with the warp: the point whose rigid composite
        # position is c appears at the x solving x - D(x, t) = c.
        # The affine part (zoom + roll) is solved EXACTLY each step and
        # only the deform term iterates: with D = D_d + D_a and
        # x - D_a(x) = ctr + M (x - ctr), M = (1/s)I + R(-th) - I
        # (both terms ADD displacements in _deform_field, hence the -I),
        # the update is x <- ctr + M^-1 (c + D_d(x) - ctr). Convergence
        # now depends only on the deform contraction — the plain
        # iteration's factor for roll alone is 2 sin(th/2), which is
        # ~0.96 at th = 57.5 deg (2.5 deg/frame x 23): 12 rounds left
        # tens of px of GT error on rot_strong's late frames (measured),
        # i.e. GT inconsistent with the rendered video. Exact-affine
        # preconditioning makes pure zoom/roll exact in ONE step.
        ctr = np.array([width / 2.0, height / 2.0])
        for t in range(num_frames):
            s_t = 1.0 + zoom_rate * t
            th = rot_rate * t
            rot_m = np.array(
                [[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]]
            )  # R(-th) acting on row-vector (x, y) columns
            m = (1.0 / s_t) * np.eye(2) + rot_m - np.eye(2)
            m_inv = np.linalg.inv(m)
            c = tracks[:, t, :].copy()
            x = c.copy()
            for _ in range(12):
                dx, dy = _deform_field(
                    (x[:, 0], x[:, 1]), t, deform_amp, deform_cycles,
                    deform_period, phases, zoom_rate=0.0, rot_rate=0.0,
                )
                x = ctr + (c + np.stack([dx, dy], axis=-1) - ctr) @ m_inv.T
            tracks[:, t] = x.astype(np.float32)
            in_b = (
                (x[:, 0] >= 0) & (x[:, 0] < width)
                & (x[:, 1] >= 0) & (x[:, 1] < height)
            )
            visible[:, t] &= in_b
    return video, tracks, visible
