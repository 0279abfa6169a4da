"""tdspa_torch's learned matcher against tdspa's: the flax weights mapped onto
the port's modules, the feature net, the cost patches (the matcher kernel's
plain version), the whole refinement and the degradation statistics.

The CUDA kernel itself runs only on a GPU (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); on the CPU its wrapper runs the plain version.

Tolerances: features at 1e-5 (L2-normalised, f32 convolutions summed in
another order); tanh-vs-exact GELU or (3, 3)-vs-(2, 3) padding would move
them by far more. Cost patches at 1e-5 (a 16-term dot product per entry);
``refine_tracks`` at 1e-3, the atol ``tests/unit/test_matcher_kernel.py``
gives the TPU kernel, since four rounds of an MLP on those costs move
positions by stride-2 feature steps.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.features import matcher as jax_matcher
from tdspa.utils.synthetic_video import make_tracking_scene
from tdspa_torch.features import matcher
from tdspa_torch.kernels.matcher import cost_patches_multi, cost_patches_reference

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree():
    return jax_matcher.load_matcher("default")


@pytest.fixture(scope="module")
def model(tree):
    return matcher.matcher_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_weights_map_from_the_shipped_flax_tree(tree, model):
    assert (model.dim, model.radius, model.hidden, model.stride, model.fhidden, model.bank) == (
        16, 4, 128, 2, 32, 3)
    conv0 = np.asarray(tree["feature"]["conv0"]["kernel"])  # [kh kw in out]
    assert conv0.shape == (7, 7, 1, 32)
    np.testing.assert_array_equal(model.feature.conv0.weight.detach().numpy(),
                                  conv0.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.head.fc1.weight.detach().numpy(),
                                  np.asarray(tree["head"]["fc1"]["kernel"]).T)
    np.testing.assert_array_equal(model.select.fc.bias.detach().numpy(),
                                  np.asarray(tree["select"]["fc"]["bias"]))
    # The port reads its own copy of the weights, not the JAX package's.
    assert os.path.realpath(matcher.default_matcher_path()) == str(
        REPO / "tdspa_torch" / "assets" / "matcher_default.npz")
    ported = matcher.load_matcher("default")
    for key in ("feature", "head", "select", "config"):
        assert set(ported[key]) == set(tree[key])


@pytest.mark.parametrize("hw", [(64, 64), (63, 70)])
def test_features_match_jax(tree, model, hw):
    """SAME padding is (2, 3) on an even side and (3, 3) on an odd one."""
    video = np.random.default_rng(0).integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    want = np.asarray(jax_matcher.compute_features(tree, video))
    with torch.no_grad():
        got = matcher.compute_features(model, torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _cost_inputs(m):
    rng = np.random.default_rng(m)
    feats = rng.standard_normal((5, 24, 28, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    tvecs = rng.standard_normal((7, m, 16)).astype(np.float32)
    # Image-pixel positions, some near and past the borders (corner clamps).
    pos = np.stack([rng.uniform(-6, 62, (7, 5)), rng.uniform(-6, 54, (7, 5))], -1).astype(np.float32)
    return feats, tvecs, pos


@pytest.mark.parametrize("m", [1, 4])
def test_cost_patches_match_jax(m):
    feats, tvecs, pos = _cost_inputs(m)
    want = jax_matcher._cost_patches_multi(jnp.asarray(feats), jnp.asarray(tvecs),
                                           jnp.asarray(pos), 4, 2)
    got = matcher._cost_patches_multi(torch.from_numpy(feats), torch.from_numpy(tvecs),
                                      torch.from_numpy(pos), 4, 2)
    assert got.shape == (7, 5, m, 81)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if m == 1:
        one = matcher._cost_patches(torch.from_numpy(feats), torch.from_numpy(tvecs[:, 0]),
                                    torch.from_numpy(pos), 4, 2)
        np.testing.assert_allclose(one.numpy(), np.asarray(want)[:, :, 0], atol=1e-5, rtol=0)


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    feats, tvecs, fpos = (torch.from_numpy(a) for a in _cost_inputs(4))
    fpos = matcher.img_to_feat(fpos, 2)
    before = cost_patches_multi.launches
    torch.testing.assert_close(cost_patches_multi(feats, tvecs, fpos, 3),
                               cost_patches_reference(feats, tvecs, fpos, 3), rtol=0, atol=0)
    assert cost_patches_multi.launches == before == 0
    with pytest.raises(ValueError, match="do not fit"):
        cost_patches_multi(feats, tvecs[:, :, :8], fpos)
    with pytest.raises(ValueError, match="expected feats"):
        cost_patches_multi(feats[0], tvecs, fpos)


def _window_dot_then_blend(feats, tvecs, fpos, radius):
    """csrc/matcher.cu's arithmetic in torch: the (2R+2)^2 window of clamped
    rows and columns around floor(fpos), its dot products with the
    templates, then each offset's blend of four products, with the plain
    version's weights (x = px + ox in f32, wx = x - floor(x); weight 1 on the
    next column where px + ox rounds up onto an integer)."""
    t, hf, wf, _ = feats.shape
    width, side = 2 * radius + 2, 2 * radius + 1
    floors = torch.floor(fpos)  # [N T 2]
    start = floors.clamp(-1e9, 1e9).long() - radius
    span = torch.arange(width)
    cols = (start[..., 0, None] + span).clamp(0, wf - 1)  # [N T W]
    rows = (start[..., 1, None] + span).clamp(0, hf - 1)
    frames = torch.arange(t)[None, :, None, None]
    window = feats[frames, rows[..., :, None], cols[..., None, :]]  # [N T W W D]
    prods = torch.einsum("ntjid,nmd->ntmji", window, tvecs)  # [N T M W W]
    offs = torch.arange(side, dtype=torch.float32) - radius
    pos = fpos[..., None] + offs  # [N T 2 side]
    weights = torch.where(torch.floor(pos) > floors[..., None] + offs, 1.0, pos - torch.floor(pos))
    wx = weights[:, :, None, 0, None, :]  # [N T 1 1 side] over kx
    wy = weights[:, :, None, 1, :, None]  # [N T 1 side 1] over ky
    costs = (prods[..., :-1, :-1] * ((1 - wx) * (1 - wy)) + prods[..., :-1, 1:] * (wx * (1 - wy))
             + prods[..., 1:, :-1] * ((1 - wx) * wy) + prods[..., 1:, 1:] * (wx * wy))
    return costs.reshape(*costs.shape[:3], side * side), cols, rows


@pytest.mark.parametrize("m", [1, 4])
def test_kernel_window_model_matches_the_plain_version(m):
    """The kernel's clamped window and its dot-then-blend order equal
    ``cost_patches_reference`` within 1e-5 at R = 4, D = 16: positions
    inside, on and past each border and corner, far outside (+-1e9), and
    one whose px + ox rounds up onto the next pixel. The window's columns
    and rows hold every corner the plain version reads."""
    rng = np.random.default_rng(10 + m)
    hf, wf, radius = 21, 26, 4
    feats = rng.standard_normal((3, hf, wf, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    tvecs = rng.standard_normal((40, m, 16)).astype(np.float32)
    tvecs /= np.linalg.norm(tvecs, axis=-1, keepdims=True)
    xs = [-1e9, -7.5, -4.2, -0.5, 0.0, 0.99999994, 3.3, 12.6, wf - 4.7, wf - 1.0, wf + 0.4, 1e9]
    ys = [-1e9, -2.1, 0.0, 0.99999994, 3.5, 10.25, hf - 1.0, hf + 3.9, 1e9]
    pts = np.array([(x, y) for x in xs for y in ys], np.float32)
    fpos = np.concatenate([pts, rng.uniform(-9, 30, (120 - len(pts), 2)).astype(np.float32)])
    fpos = torch.from_numpy(fpos.reshape(40, 3, 2))  # 108 chosen + 12 random positions
    feats_t, tvecs_t = torch.from_numpy(feats), torch.from_numpy(tvecs)
    got, cols, rows = _window_dot_then_blend(feats_t, tvecs_t, fpos, radius)
    want = cost_patches_reference(feats_t, tvecs_t, fpos, radius)
    assert got.shape == want.shape == (40, 3, m, 81)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    # Offset k's corners in the plain version: floor(px + ox) and the next,
    # each clamped; they are window columns kx and kx + 1 (kx + 1 alone
    # where px + ox rounded up, the weight then all on it).
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    for axis, lines, size in ((0, cols, wf), (1, rows, hf)):
        floor = torch.floor(fpos[..., axis, None] + offs)
        corner = floor.clamp(-1e9, 1e9).long()
        plain0, plain1 = corner.clamp(0, size - 1), (corner + 1).clamp(0, size - 1)
        shifted = floor > torch.floor(fpos[..., axis, None]) + offs
        assert shifted.any()  # the rounding case is in the set
        window0, window1 = lines[..., :-1], lines[..., 1:]
        assert torch.equal(torch.where(shifted, window1, window0), plain0)
        assert torch.equal(plain1[~shifted], window1[~shifted])


def test_refine_tracks_matches_jax(tree, model):
    video, gt, _ = make_tracking_scene(num_frames=6, height=64, width=64, grid_size=5,
                                       noise_sigma=10.0)
    tracks = (gt + np.random.default_rng(1).normal(0, 1.5, gt.shape)).astype(np.float32)
    want_pos, want_vis = jax_matcher.refine_tracks(tree, video, tracks, backend="xla")
    got_pos, got_vis = matcher.refine_tracks(model, torch.from_numpy(video),
                                             torch.from_numpy(tracks))
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_vis.numpy(), np.asarray(want_vis), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got_pos[:, 0].numpy(), tracks[:, 0])  # frame 0 kept


@pytest.mark.parametrize("num_frames", [4, 6])
def test_degradation_stats_match_jax_on_an_even_frame_count(num_frames):
    """jnp.median averages the two middle values of an even count; so must
    the flicker statistic here (torch.median would take the lower one)."""
    video, _, _ = make_tracking_scene(num_frames=num_frames, height=64, width=96, grid_size=4,
                                      noise_sigma=6.0, gain_flicker=0.2)
    want = [float(x) for x in jax_matcher._degradation_stats(video)]
    got = [float(x) for x in matcher._degradation_stats(torch.from_numpy(video))]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    gray = (video.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))
    got_gray = [float(x) for x in matcher._degradation_stats(torch.from_numpy(gray))]
    np.testing.assert_allclose(got_gray, [float(x) for x in jax_matcher._degradation_stats(gray)],
                               rtol=1e-4, atol=1e-6)
    want_d = jax_matcher.estimate_degradation(video)
    got_d = matcher.estimate_degradation(torch.from_numpy(video))
    assert got_d["degraded"] == want_d["degraded"]
    assert got_d["noise_sigma"] == pytest.approx(want_d["noise_sigma"], rel=1e-4)


