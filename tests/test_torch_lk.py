"""tdspa_torch's LK tracking ops against tdspa's: the plain LK version
(``tdspa_torch.ops.lk``, the LK kernel's plain version) against
``tdspa.ops.lk.track_video_lk``; the chunking arguments; chunked against
unchunked tracking; the YUV 4:2:0 wire format; the denoise blur and the
roll-stabilise warp.

The CUDA kernel itself runs only on a GPU (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); on the CPU its wrapper runs the plain version.

Tolerances: LK tracks within 1e-3 px and visibility agreement >= 99 %. Both
sides do the same f32 arithmetic, but XLA and torch sum the 49-pixel window
reductions in different orders; Gauss-Newton carries those last-bit
differences from frame to frame, and the NCC > 0.7 / > 0.5 and min_eig
thresholds can flip on them. The blur and the similarity fit hold at 1e-4
(1-D convolution and reduction order); the warp at 1e-4 on luma in [0, 1]
(its resampling is a matrix product, summed in another order).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.ops import filters as jax_filters
from tdspa.ops import lk as jax_lk
from tdspa.ops import warp as jax_warp
from tdspa.ops import yuv as jax_yuv
from tdspa.utils.synthetic_video import make_tracking_scene
from tdspa_torch.features.tracks import PyramidalLKTracker, make_query_grid
from tdspa_torch.kernels import lk as klk
from tdspa_torch.kernels.lk import track_video_lk_kernel
from tdspa_torch.ops import filters, lk, warp, yuv

# The four configurations chip_smoke.py holds the kernel to.
CONFIGS = {
    "pipeline_default": dict(fb_threshold=-1.0, iterations=3),
    "tracker_default": dict(fb_threshold=2.0, iterations=4),
    "corr_rescue": dict(corr_radius=4, corr_rescue_level=2),
    "half_res": dict(input_scale=0.5),
}


def _tiny_scene():
    video, _, _ = make_tracking_scene(num_frames=8, height=64, width=96, grid_size=6)
    return video, make_query_grid(64, 96, 6)


def _pan_scene():
    video, _, _ = make_tracking_scene(num_frames=24, height=128, width=128, grid_size=8,
                                      pan=(8, 0))
    return video, make_query_grid(128, 128, 8)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_lk_matches_jax(config):
    video, queries = _tiny_scene()
    want_tracks, want_vis = jax_lk.track_video_lk(video, queries, **CONFIGS[config])
    got_tracks, got_vis = lk.track_video_lk(torch.from_numpy(video), queries, **CONFIGS[config])
    assert got_tracks.shape == (36, 8, 2) and got_vis.shape == (36, 8, 1)
    np.testing.assert_allclose(got_tracks.numpy(), np.asarray(want_tracks), atol=1e-3, rtol=0)
    assert (got_vis.numpy() == np.asarray(want_vis)).mean() >= 0.99


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    video, queries = _tiny_scene()
    before = track_video_lk_kernel.launches
    got = track_video_lk_kernel(torch.from_numpy(video), queries, return_velocity=True)
    want = lk.track_video_lk(torch.from_numpy(video), queries, return_velocity=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert track_video_lk_kernel.launches == before == 0
    with pytest.raises(TypeError, match="torch.Tensor"):
        track_video_lk_kernel(video, queries)


def _kernel_samples(img, xs, ys):
    """csrc/lk.cu::sample_at in torch, for samplings of a window (rows of xs,
    ys [S K]): where every corner of a sampling lies inside the level, its
    samples read the pixels at floor(y) * w + floor(x) and the next column
    and row with no clamps; other samplings take the clamped per-sample path
    (ops/lk.py's bilinear). Returns (samples [S K], inside [S])."""
    h, w = img.shape
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    wx, wy = xs - x0f, ys - y0f
    xi, yi = x0f.clamp(-2**31, 2**31 - 1).long(), y0f.clamp(-2**31, 2**31 - 1).long()
    inside = ((xi >= 0) & (xi < w - 1) & (yi >= 0) & (yi < h - 1)).all(-1)
    out = lk.bilinear(img, torch.stack([xs, ys], -1))
    flat = img.reshape(-1)
    at = (yi * w + xi)[inside]
    wx, wy = wx[inside], wy[inside]
    out[inside] = (flat[at] * (1 - wx) * (1 - wy) + flat[at + 1] * wx * (1 - wy)
                   + flat[at + w] * (1 - wx) * wy + flat[at + w + 1] * wx * wy)
    return out, inside


@pytest.mark.parametrize("input_scale", [1.0, 0.5])
def test_kernel_interior_path_reads_the_plain_corners(input_scale):
    """The LK kernel's interior path, modelled in torch, reads exactly the
    corners that ops/lk.py's bilinear reads where it is taken, and gives its
    samples bit for bit, at each of 3 levels for window 7: the samplings of
    the template patch, of the two central differences and of Gauss-Newton
    steps, around positions near each border and corner of the level; the
    other samplings take the clamped path."""
    video, _ = _tiny_scene()
    gray = lk.prepare_inputs(torch.from_numpy(video), make_query_grid(64, 96, 6), None, None,
                             None, 2.0, input_scale)[0]
    offs = lk.window_offsets(7)
    rng = np.random.default_rng(int(input_scale * 10))
    taken = total = 0
    for level in lk.build_pyramid(gray, 3):
        img = level[3]
        h, w = img.shape

        def near(size):
            return [-3.7, -0.5, 0.0, 0.7, 2.5, 3.0, 3.4999998, 3.9999998, 4.2, size / 2 + 0.37,
                    size - 5.5, size - 4.5, size - 4.0, size - 1.0, size + 1.6]

        pts = torch.tensor([(x, y) for x in near(w) for y in near(h)], dtype=torch.float32)
        steps = torch.from_numpy(rng.uniform(-2.5, 2.5, pts.shape).astype(np.float32))
        cx, cy = pts[:, 0:1] + offs[:, 0], pts[:, 1:2] + offs[:, 1]  # [P K] as ops/lk.py forms them
        samplings = [(cx, cy), (cx + 0.5, cy), (cx - 0.5, cy), (cx, cy + 0.5), (cx, cy - 0.5),
                     (cx + steps[:, 0:1], cy + steps[:, 1:2])]
        for xs, ys in samplings:
            got, inside = _kernel_samples(img, xs, ys)
            assert torch.equal(got, lk.bilinear(img, torch.stack([xs, ys], -1)))
            # Where the interior path is taken, the clamps change no corner.
            x0, y0 = torch.floor(xs[inside]).long(), torch.floor(ys[inside]).long()
            assert torch.equal(x0.clamp(0, w - 1), x0) and torch.equal((x0 + 1).clamp(0, w - 1), x0 + 1)
            assert torch.equal(y0.clamp(0, h - 1), y0) and torch.equal((y0 + 1).clamp(0, h - 1), y0 + 1)
            taken += int(inside.sum())
            total += inside.numel()
    assert 0 < taken < total  # both paths ran


@pytest.mark.parametrize("window", [5, 7])
def test_kernel_cost_volume_taps_are_pixels(window):
    """With an odd window the cost volume's candidates (round-half-up
    centre + integer offsets) and their taps lie on pixels, where ops/lk.py's
    bilinear gives the clamped pixel itself: the LK kernel reads one pixel
    per tap, from the patch's rows with no clamps where the patch is inside
    the frame."""
    video, _ = _tiny_scene()
    img = lk.to_gray(torch.from_numpy(video))[2]
    h, w = img.shape
    est = torch.tensor([[-9.6, 3.2], [0.5, 0.49], [2.5, 61.5], [40.3, 30.7], [93.6, 62.2],
                        [95.0, 70.4], [1e9, -1e9]])
    d = torch.arange(-4, 5, dtype=torch.float32)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    centers = torch.floor(est + 0.5)[:, None] + torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)
    taps = centers[:, :, None] + lk.window_offsets(window)  # [P 81 K 2]
    want = lk.bilinear(img, taps)
    xi = taps[..., 0].clamp(-1e9, 1e9).long().clamp(0, w - 1)
    yi = taps[..., 1].clamp(-1e9, 1e9).long().clamp(0, h - 1)
    assert torch.equal(img[yi, xi], want)
    half = (window - 1) // 2
    cx, cy = centers[..., 0], centers[..., 1]
    inside = (cx - half >= 0) & (cx + half <= w - 1) & (cy - half >= 0) & (cy + half <= h - 1)
    assert 0 < int(inside.sum()) < inside.numel()
    k = torch.arange(window * window)
    base = (cy[inside] - half).long()[:, None] * w + (cx[inside] - half).long()[:, None]
    assert torch.equal(img.reshape(-1)[base + (k // window) * w + k % window], want[inside])


@pytest.mark.parametrize("input_scale", [1.0, 0.5])
def test_chunking_arguments_at_their_defaults_change_nothing(input_scale):
    video, queries = _tiny_scene()
    v = torch.from_numpy(video)
    kw = dict(CONFIGS["corr_rescue"], input_scale=input_scale, return_velocity=True)
    plain = lk.track_video_lk(v, queries, **kw)
    explicit = lk.track_video_lk(
        v, queries, template_frame=lk.to_gray(v[:1])[0], template_pos=queries,
        init_velocity=np.zeros_like(queries), **kw,
    )
    for a, b in zip(plain, explicit):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("input_scale", [1.0, 0.5])
def test_chunked_tracking_matches_unchunked(input_scale):
    """track_chunks (4 chunks) == one call on the whole video.

    At input_scale 0.5 a chunk boundary passes each position through
    full-resolution pixels (x * 2 + 0.5, then (x - 0.5) / 2), which rounds
    where the value crosses a power of two, as on the TPU path; the lost
    points of this fast pan carry that forward, so there the bound is 1e-3 px
    on 99 % of the (point, frame) pairs.
    """
    video, queries = _pan_scene()
    tracker = PyramidalLKTracker(grid_size=8, fb_threshold=-1.0, iterations=3,
                                 input_scale=input_scale, device="cpu")
    chunks = [torch.from_numpy(video[i : i + 7]) for i in range(0, 24, 7)]
    got = tracker.track_chunks(chunks)
    want_tracks, want_vis = lk.track_video_lk(
        torch.from_numpy(video), queries, fb_threshold=-1.0, iterations=3, input_scale=input_scale
    )
    assert got["tracks"].shape == want_tracks.shape == (64, 24, 2)
    if input_scale == 1.0:
        torch.testing.assert_close(got["tracks"], want_tracks, atol=1e-5, rtol=0)
        torch.testing.assert_close(got["visible"], want_vis, atol=0, rtol=0)
    else:
        err = (got["tracks"] - want_tracks).abs().amax(-1)
        assert (err <= 1e-3).float().mean() >= 0.99
        assert (got["visible"] == want_vis).float().mean() >= 0.99


def test_yuv420_matches_jax_bit_for_bit(monkeypatch):
    video, _ = _tiny_scene()
    monkeypatch.setitem(sys.modules, "cv2", None)  # JAX's numpy encoder, as in the port
    want = jax_yuv.rgb_to_yuv420(video)
    got = yuv.rgb_to_yuv420(video)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rgb = yuv.yuv420_to_rgb(*(torch.from_numpy(p) for p in got))
    assert rgb.dtype == torch.uint8 and rgb.shape == video.shape
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jax_yuv.yuv420_to_rgb(*want)))
    with pytest.raises(ValueError, match="even"):
        yuv.rgb_to_yuv420(video[:, :63])


def _luma(video):
    return (video.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))


def test_gaussian_blur_matches_jax():
    video, _ = _tiny_scene()
    gray = _luma(video)
    for sigma in (3.0, 1.5):
        want = jax_filters.gaussian_blur_video(gray, sigma=sigma)
        got = filters.gaussian_blur_video(torch.from_numpy(gray), sigma=sigma)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    flat = torch.full((2, 12, 16), 7.0)
    torch.testing.assert_close(filters.gaussian_blur_video(flat), flat)


def _roll_scene():
    video, tracks, _ = make_tracking_scene(num_frames=8, height=64, width=96, grid_size=6,
                                           rot_rate=float(np.deg2rad(6.0)))
    return video, tracks


def test_similarity_fit_matches_jax():
    _, tracks = _roll_scene()
    noisy = tracks + np.random.default_rng(0).normal(0, 0.3, tracks.shape).astype(np.float32)
    noisy[:3] += 40.0  # outliers the reweighting must drop
    want = jax_warp.fit_similarity_sequence(noisy)
    got = warp.fit_similarity_sequence(torch.from_numpy(noisy))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    assert float(got["angle_deg"][-1]) == pytest.approx(42.0, abs=2.0)
    pos = noisy[:, :1].repeat(8, 1)
    np.testing.assert_allclose(
        warp.apply_similarity(got["A"], got["t"], torch.from_numpy(pos)).numpy(),
        np.asarray(jax_warp.apply_similarity(want["A"], want["t"], jnp.asarray(pos))),
        atol=1e-4, rtol=0,
    )


def test_warp_video_similarity_matches_jax():
    video, tracks = _roll_scene()
    gray = _luma(video) / 255.0
    fit = jax_warp.fit_similarity_sequence(tracks)
    a_mat, t_vec = np.asarray(fit["A"]), np.asarray(fit["t"])
    want = jax_warp.warp_video_similarity(gray, a_mat, t_vec)
    got = warp.warp_video_similarity(torch.from_numpy(gray), torch.from_numpy(a_mat),
                                     torch.from_numpy(t_vec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_kernel_builds_without_contraction():
    """The kernel's thresholded decisions see the plain version's values only
    without fused multiply-adds."""
    assert "--fmad=false" in klk.build.flags("lk")
