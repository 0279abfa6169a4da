"""tdspa_torch.features.depth with Video Depth Anything's temporal head against the plain
reference ``tests/plain/vda.py``: the head's motion modules where ``dpt_temporal.py``
places them, VDA's 32-frame windows with their keyframes, a checkpoint of another layout
refused, and the reference equal to the benchmark's copy.

Tiny widths with unequal ``out_channels[2]`` (64), ``out_channels[3]`` (96) and
``features`` (32), so that a module built at or applied to the wrong map cannot load or
match; 48 x 48 frames resized to the tiny encoder's native 56 x 56 (a 4 x 4 grid), so that
no position resize enters. Seeded random weights under the released state_dict's names,
loaded through ``from_checkpoint``. Tolerance: float32 on both sides, sums in another
order through ~40 layers: 2e-5 of the depth's range.
"""

from pathlib import Path

import pytest
import torch

from tdspa_torch.features import depth
from tdspa_torch.features.vit import ViTConfig
from tests.plain import vda as plain

KEYFRAMES = [0, 12, 24, 25, 26, 27, 28, 29, 30, 31]
TINY = {
    "encoder": dict(hidden_size=32, num_layers=4, num_heads=2, mlp_ratio=4, patch_size=14,
                    image_size=56, layer_norm_eps=1e-6),
    "layer_idxs": [0, 1, 2, 3],
    "features": 32,
    "out_channels": [16, 24, 64, 96],
    "motion": dict(num_attention_heads=8, num_transformer_block=1, num_attention_blocks=2,
                   temporal_max_len=32, norm_num_groups=32, group_norm_eps=1e-6,
                   layer_norm_eps=1e-5, ff_mult=4),
    "window": 32, "overlap": 10, "keyframes": KEYFRAMES, "input_size": 56,
}
HEAD_CFG = {k: TINY[k] for k in ("features", "out_channels", "layer_idxs")}
LAWS = {"kernel": (None, 0.0), "bias": (0.02, 0.0), "scale": (0.1, 1.0), "state": (1.0, 0.0)}


def _weights(seed=0, widths=None):
    """Seeded weights under the released names; ``widths`` overrides the motion
    modules' (the old all-``features`` layout)."""
    cfg = dict(TINY)
    gen = torch.Generator().manual_seed(seed)
    shapes = plain.param_shapes(cfg)
    if widths is not None:
        shapes = {k: v for k, v in shapes.items() if ".motion_modules." not in k}
        for i, c in enumerate(widths):
            shapes.update({k.replace(".motion_modules.0.", f".motion_modules.{i}."): v
                           for k, v in plain.param_shapes(
                               {**cfg, "out_channels": [16, 24, c, c], "features": c}).items()
                           if ".motion_modules.0." in k})
    out = {}
    for name, (shape, law, fan_in) in shapes.items():
        scale, offset = LAWS[law]
        scale = fan_in ** -0.5 if scale is None else scale
        out[name] = torch.randn(shape, generator=gen) * scale + offset
    out[plain.OUTPUT_BIAS] += 1.0  # keep the final ReLU mostly open
    return out


def _estimator(weights, tmp_path):
    path = tmp_path / "video_depth_anything_tiny.pth"
    torch.save(weights, path)
    return depth.VideoDepthEstimator.from_checkpoint(
        str(path), encoder="vitl", dtype=torch.float32, head_cfg=HEAD_CFG,
        vit_config=ViTConfig(**TINY["encoder"]), input_size=56, device="cpu")


def _video(t, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (t, 48, 48, 3), generator=gen, dtype=torch.uint8)


def test_vda_head_and_windows_match_the_plain_reference(tmp_path):
    """150 frames: 7 windows, 224 frame passes; every frame's depth equals the
    reference's, and the frames really couple (reversing the video changes them)."""
    weights = _weights()
    est = _estimator(weights, tmp_path)
    assert est.head.use_motion_modules and not est.head.use_temporal
    assert est.head.motion_widths == (64, 96, 32, 32)
    video = _video(150)
    depth.depth_window.windows = depth.depth_window.frame_passes = 0
    got = est(video)
    assert (depth.depth_window.windows, depth.depth_window.frame_passes) == (7, 224)
    with torch.no_grad():
        want = plain.VDA(TINY, weights).video(video)
    assert got.shape == want.shape == (150, 48, 48, 1)
    scale = float(want.abs().max())
    assert scale > 0.1 and float((want > 0).float().mean()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * scale)
    reversed_ = est(video.flip(0)).flip(0)
    assert float((reversed_ - got).abs().max()) > 1e-3 * scale


def test_vda_windows_for_150_frames():
    """VDA's schedule: window 0 is frames 0-31; window k reads frame 0, frame 22k - 10
    and frames 22k + 2 ... 22k + 9 (the previous window's keyframe inputs), then gives
    frames 22k + 10 ... 22k + 31, the last clamped to frame 149."""
    windows = depth.vda_windows(150)
    assert len(windows) == 7 and sum(len(inputs) for inputs, _ in windows) == 224
    assert windows[0] == (list(range(32)), 0)
    for k, (inputs, first) in enumerate(windows[1:], start=1):
        assert first == 10 and len(inputs) == 32
        keys = [0, 22 * k - 10] + list(range(22 * k + 2, 22 * k + 10)) if k > 1 else KEYFRAMES
        assert inputs[:10] == keys
        assert inputs[10:] == [min(f, 149) for f in range(22 * k + 10, 22 * k + 32)]
    given = list(range(32)) + [f for inputs, _ in windows[1:] for f in inputs[10:]]
    assert given[:150] == list(range(150))
    assert len(depth.vda_windows(32)) == 1 and len(depth.vda_windows(33)) == 2


def test_old_all_features_layout_is_refused(tmp_path):
    """A checkpoint whose motion modules are all ``features`` wide (the layout that
    placed them after each fusion) names both layouts' widths."""
    weights = _weights(widths=[32, 32, 32, 32])
    with pytest.raises(ValueError, match=r"\[32, 32, 32, 32\].*\[64, 96, 32, 32\]"):
        _estimator(weights, tmp_path)


def test_named_models_and_heads():
    """``vda_model`` names the released models; the two temporal heads exclude each other;
    only disjoint groups stream by chunks."""
    assert depth.vda_model("depth-anything/Video-Depth-Anything-Large") == {
        "encoder": "vitl", "use_temporal": False, "use_motion_modules": True}
    with pytest.raises(ValueError, match="Video Depth Anything"):
        depth.vda_model("depth-anything/Video-Depth-Anything-Huge")
    with pytest.raises(ValueError, match="pick one"):
        depth.DPTHead(32, 16, [8, 16, 24, 32], use_temporal=True, use_motion_modules=True)
    kwargs = dict(vit_config=ViTConfig(**TINY["encoder"]), head_cfg=HEAD_CFG, device="cpu",
                  dtype=torch.float32)
    vda = depth.VideoDepthEstimator(encoder="vitl", use_temporal=False, use_motion_modules=True,
                                    **kwargs)
    groups = depth.VideoDepthEstimator(encoder="vitl", frame_chunk=8, **kwargs)
    assert not vda.chunk_invariant(40) and not vda.chunk_invariant(64)
    assert groups.chunk_invariant(40) and not groups.chunk_invariant(36)


def test_plain_reference_is_the_benchmark_reference():
    """The benchmark's frozen copy (``benchmark/reference/vda.py``) is this text."""
    root = Path(__file__).resolve().parents[1]
    assert (root / "benchmark" / "reference" / "vda.py").read_text() == \
        (root / "tests" / "plain" / "vda.py").read_text()
