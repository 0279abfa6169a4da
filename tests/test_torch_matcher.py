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

import ctypes
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.features import matcher as jax_matcher
from tdspa.utils.synthetic_video import make_tracking_scene
from tdspa_torch.features import matcher
from tdspa_torch.kernels import matcher as kmatcher
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


def test_ctypes_signature_matches_the_cuda_entry_point():
    """The kernel loads only on a GPU host; its C signature is checked here."""
    src = (Path(kmatcher.build.CSRC) / "matcher.cu").read_text()
    decl = re.search(r'extern "C" int tdspa_cost_patches\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in decl.split(",")]
    kinds = [
        ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float") else ctypes.c_int
        for p in params
    ]
    assert kinds == kmatcher.ARGTYPES
    assert "matcher" in kmatcher.build.KERNELS
