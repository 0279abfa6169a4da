"""tdspa_torch's PyramidalLKTracker against tdspa's, both on the CPU with the
adaptive ``matcher="auto"`` policy, on five tiny synthetic scenes that each
engage a different tier: clean (none), degraded (the matcher), fast pan (the
cost-volume rescue), camera roll (roll-stabilise) and heavy noise over
natural texture (the rescue runs and is discarded, then the denoise re-track
is kept). Then the pipeline's
streamed branch end to end on the CPU, and the tracker's device default.

Agreement: the same tier decisions; visibility agreement >= 99 %; tracks
within 1e-3 px on >= 95 % of the (point, frame) pairs that both mark
visible; and pts_within_2 / visibility_accuracy against the ground truth
within 0.02 of the JAX tracker's. The two do the same f32 arithmetic with
reductions summed in another order: a tracked point stays within 1e-3 px,
but points the tracker has lost (fast pan: most of them until the rescue)
amplify last-bit differences frame after frame, and the rescue's cost
volume can pick another of two near-equal peaks, so those are held to the
ground-truth metrics instead.
"""

import numpy as np
import pytest
import torch

import tdspa.ops.lk as jax_lk
from tdspa.features.tracks import PyramidalLKTracker as JaxTracker
from tdspa.utils.synthetic_video import make_tracking_scene
from tdspa_torch.eval.tracking_quality import tracking_quality
from tdspa_torch.features.depth import ConstantDepthProvider
from tdspa_torch.features.tracks import PyramidalLKTracker
from tdspa_torch.infer.pipeline import InferencePipeline
from tdspa_torch.kernels.lk import track_video_lk_kernel
from tdspa_torch.ops.yuv import rgb_to_yuv420, yuv420_to_rgb
from tdspa_torch.utils.testing import tiny_model_3d

SCENES = {
    "clean": dict(num_frames=12, height=96, width=128, grid_size=8),
    "degraded": dict(num_frames=12, height=96, width=128, grid_size=8, noise_sigma=16.0, seed=1),
    "pan": dict(num_frames=24, height=128, width=128, grid_size=8, pan=(8, 0)),
    "roll": dict(num_frames=24, height=128, width=128, grid_size=8,
                 rot_rate=float(np.deg2rad(2.5))),
    "denoise": dict(num_frames=12, height=96, width=128, grid_size=8, noise_sigma=10.0,
                    contrast=0.7, texture="natural"),
}
EXPECTED_TIERS = {
    "clean": {"stabilize": None, "rescue": None, "denoise": None, "matcher": None},
    "degraded": {"stabilize": None, "rescue": None, "denoise": None, "matcher": True},
    "pan": {"stabilize": None, "rescue": True, "denoise": None, "matcher": None},
    "roll": {"stabilize": True, "rescue": None, "denoise": None, "matcher": None},
    "denoise": {"stabilize": None, "rescue": False, "denoise": True, "matcher": None},
}
POLICY = dict(grid_size=8, fb_threshold=-1.0, iterations=3, matcher="auto")


def _jax_call_with_tiers(video, monkeypatch):
    """The JAX tracker's output and the tiers it ran, read off its calls."""
    tracker = JaxTracker(device="cpu", **POLICY)
    tiers = {"stabilize": None, "rescue": None, "denoise": None, "matcher": None}
    orig_lk = jax_lk.track_video_lk

    def lk(video, queries, **kw):
        out = orig_lk(video, queries, **kw)
        if kw.get("corr_radius") == 4 and tracker.corr_radius == 0:
            tiers["rescue"] = False  # ran; True below if kept
        elif np.ndim(video) == 3 and tiers["stabilize"] is None:
            tiers["denoise"] = False
        return out

    monkeypatch.setattr(jax_lk, "track_video_lk", lk)
    rescue, denoise = tracker._maybe_rescue, tracker._maybe_denoise
    stabilized, apply_matcher = tracker._stabilized_result, tracker._apply_matcher

    def maybe_rescue(*a, **k):
        out = rescue(*a, **k)
        if tiers["rescue"] is not None:
            tiers["rescue"] = out[2] > 0.0
        return out

    def maybe_denoise(*a, **k):
        out = denoise(*a, **k)
        if tiers["denoise"] is not None:
            tiers["denoise"] = out[2]
        return out

    def stabilized_result(*a, **k):
        tiers["stabilize"] = True
        return stabilized(*a, **k)

    def matcher(*a, **k):
        tiers["matcher"] = True
        return apply_matcher(*a, **k)

    tracker._maybe_rescue, tracker._maybe_denoise = maybe_rescue, maybe_denoise
    tracker._stabilized_result, tracker._apply_matcher = stabilized_result, matcher
    return tracker(video), tiers


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tracker_policy_matches_jax(scene, monkeypatch):
    video, gt_tracks, gt_visible = make_tracking_scene(**SCENES[scene])
    want, want_tiers = _jax_call_with_tiers(video, monkeypatch)
    tracker = PyramidalLKTracker(device="cpu", **POLICY)
    got = tracker(video)
    assert want_tiers == EXPECTED_TIERS[scene]
    assert tracker.tiers == EXPECTED_TIERS[scene]
    got_tracks, got_vis = got["tracks"].numpy(), got["visible"].numpy()
    want_tracks, want_vis = np.asarray(want["tracks"]), np.asarray(want["visible"])
    assert got_tracks.shape == want_tracks.shape and got_vis.shape == want_vis.shape
    assert (got_vis == want_vis).mean() >= 0.99
    both = (got_vis[..., 0] > 0) & (want_vis[..., 0] > 0)
    err = np.abs(got_tracks - want_tracks).max(-1)
    assert (err[both] <= 1e-3).mean() >= 0.95
    q_got = tracking_quality({"tracks": got_tracks, "visible": got_vis}, gt_tracks, gt_visible)
    q_want = tracking_quality({"tracks": want_tracks, "visible": want_vis}, gt_tracks, gt_visible)
    for key in ("pts_within_2", "visibility_accuracy"):
        assert q_got[key] >= q_want[key] - 0.02, (key, q_got, q_want)


def test_tracker_defaults_to_the_gpu_and_raises_without_one():
    import inspect

    assert inspect.signature(PyramidalLKTracker).parameters["device"].default == "cuda"
    tracker = PyramidalLKTracker(device="cpu")
    assert tracker.backend_for((2, 64, 64, 3)) == "cpu" and tracker.prefers_device_input(None)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PyramidalLKTracker()


def test_pipeline_streams_and_tracks_with_the_default_tracker():
    """run_on_frames with no track provider: the port's LK tracker, fed the
    YUV 4:2:0 upload in 4-frame chunks (streamed branch), equals one tracker
    call on the reconstructed video."""
    t, h, w = 10, 64, 64
    video, _, _ = make_tracking_scene(num_frames=t, height=h, width=w, grid_size=4,
                                      sprite_size=16)
    pipe = InferencePipeline(
        num_output_frames=t, num_query_points=6, num_support_tracks=10, tracking_grid_size=4,
        use_depth=False, dino_extractor=lambda v: np.zeros((t, 3, 3, 768), np.float32),
        depth_provider=ConstantDepthProvider(), upload_chunk_frames=4,
        model=tiny_model_3d(t, device="cpu", use_depth=False), device="cpu",
    )
    before = track_video_lk_kernel.launches
    results = pipe.run_on_frames(video)
    assert track_video_lk_kernel.launches == before  # the CPU ran the plain version
    assert isinstance(pipe.track_provider, PyramidalLKTracker)
    assert pipe.track_provider.device.type == "cpu"
    assert "upload_tracking_features" in results["timings"]
    assert "tracking" not in results["timings"] and "video_upload" not in results["timings"]
    rebuilt = yuv420_to_rgb(*(torch.from_numpy(p) for p in rgb_to_yuv420(video)))
    single = PyramidalLKTracker(grid_size=4, fb_threshold=-1.0, iterations=3, matcher="auto",
                                device="cpu")(rebuilt)
    torch.testing.assert_close(results["tracks_3d"][..., :2], single["tracks"], atol=1e-4, rtol=0)
    assert results["predictions"].tracks.shape == (1, 6, t, 3)
    assert torch.isfinite(results["predictions"].tracks).all()
