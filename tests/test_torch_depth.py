"""tdspa_torch.features.depth against tdspa.features.depth: the video depth
estimator (DPT head with temporal attention, edge-replicated frame groups,
resize in and out) and the VDA converters. The port's VDA temporal head,
which places its motion modules as Video Depth Anything does and not as the
JAX package does, is held to a plain reference in test_torch_vda.py.

Tiny configuration of tests/unit/test_depth.py (ViT hidden 32, 4 layers all
tapped, head features 16) with a perturbed JAX parameter tree. Tolerance:
f32 on both sides, sums in another order through ~30 layers: 2e-4 relative
to the depth's range; the converters copy arrays, so their trees are equal
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.features import depth as jax_depth
from tdspa.features.vit import ViTConfig as JaxViTConfig
from tdspa_torch.features import depth
from tdspa_torch.features.vit import ViTConfig
from tests.unit.test_vda_convert import (
    FEATURES, HEADS, HIDDEN, IMG, LAYER_IDXS, LAYERS, OUT_CHANNELS, PATCH, _TorchVDAOracle,
)

TINY_VIT = dict(hidden_size=HIDDEN, num_layers=LAYERS, num_heads=HEADS, patch_size=PATCH,
                image_size=IMG)
HEAD_CFG = {"features": FEATURES, "out_channels": list(OUT_CHANNELS),
            "layer_idxs": list(LAYER_IDXS)}
RTOL = 2e-4


def _estimators(frame_chunk=2, input_size=56, seed=0, **kwargs):
    jax_est = jax_depth.VideoDepthEstimator(
        encoder="vitb", use_temporal=True, dtype=jnp.float32, frame_chunk=frame_chunk,
        vit_config=JaxViTConfig(**TINY_VIT), head_cfg=HEAD_CFG, input_size=input_size, **kwargs)
    params = jax_est.init_params(jax.random.PRNGKey(seed), sample_hw=(56, 42))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)
    # Keep the head's final ReLU mostly open, so the comparison is not 0 == 0.
    params["head"]["head_conv3"]["bias"] = params["head"]["head_conv3"]["bias"] + 1.0
    jax_est.params = params
    est = depth.VideoDepthEstimator(
        encoder="vitb", params=params, use_temporal=True, dtype=torch.float32,
        frame_chunk=frame_chunk, vit_config=ViTConfig(**TINY_VIT), head_cfg=HEAD_CFG,
        input_size=input_size, device="cpu", **kwargs)
    return jax_est, est


def _video(t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, 60, 44, 3)).astype(np.uint8)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0.1  # the head's output is not all zero
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("output_scale", [1.0, 0.5])
def test_estimator_matches_jax_with_padding(output_scale):
    """5 frames in 2-frame groups: the last group repeats frame 4. 60x44 ->
    56x42 for the backbone (a 4x3 grid, position embeddings interpolated from
    2x2), the head at ``output_scale``, and back to 60x44."""
    jax_est, est = _estimators(output_scale=output_scale)
    video = _video(5)
    got = est(video)
    assert got.shape == (5, 60, 44, 1) and bool((got >= 0).all())
    _close(got, jax_est(video))


def test_edge_replication_is_the_padding():
    """The padded frame is a copy of the last one, so it joins temporal
    attention: 3 frames equal the first 3 of [f0, f1, f2, f2]."""
    _, est = _estimators(seed=1)
    video = _video(3, seed=1)
    padded = np.concatenate([video, video[-1:]])
    torch.testing.assert_close(est(video), est(padded)[:3], rtol=0, atol=1e-6)
    zero_padded = np.concatenate([video, np.zeros_like(video[-1:])])
    assert (est(zero_padded)[:3] - est(video)).abs().max() > 1e-4  # the padding matters


def test_estimator_refuses_bad_knobs():
    for kwargs in ({"output_scale": 0.0}, {"output_scale": 1.5}, {"input_size": 7}):
        with pytest.raises(ValueError):
            depth.VideoDepthEstimator(encoder="vits", device="cpu", **kwargs)


def test_estimator_without_weights_warns_and_seeds(caplog):
    kwargs = dict(encoder="vitb", dtype=torch.float32, frame_chunk=2,
                  vit_config=ViTConfig(**TINY_VIT), head_cfg=HEAD_CFG, input_size=28,
                  device="cpu", seed=4)
    a, b = depth.VideoDepthEstimator(**kwargs), depth.VideoDepthEstimator(**kwargs)
    video = _video(2)
    torch.testing.assert_close(a(video), b(video), rtol=0, atol=0)
    assert "RANDOM" in caplog.text and a.has_weights


def test_converters_match_jax():
    """The converters map an AnimateDiff-keyed checkpoint key for key (the
    tiny oracle's motion modules are all ``features`` wide; conversion does
    not look at widths)."""
    torch.manual_seed(0)
    oracle = _TorchVDAOracle(with_motion=True).eval()
    state = oracle.state_dict()
    assert depth.motion_module_structure(state) == jax_depth.motion_module_structure(state)
    assert depth.motion_module_structure(["head.projects.0.weight"]) is None
    want = jax_depth.convert_vda_params(state, vit_config=JaxViTConfig(**TINY_VIT),
                                        head_cfg=HEAD_CFG)
    got = depth.convert_vda_params(state, vit_config=ViTConfig(**TINY_VIT), head_cfg=HEAD_CFG)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_extract_depth_features_returns_host_arrays():
    _, est = _estimators()
    video = _video(2)
    out = depth.extract_depth_features(video, provider=est)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32 and out.shape == (2, 60, 44, 1)
    np.testing.assert_array_equal(depth.extract_depth_features(video, depth.ConstantDepthProvider()),
                                  np.ones((2, 60, 44, 1), np.float32))
