"""tdspa_torch's video entry points against tdspa's, on the CPU: video file
I/O, ``InferencePipeline.run(video_path)``, ``run_inference``,
``extract_2d_tracks`` and the infer CLI, with a tiny model, unit depth and a
small LK grid.

Tolerances: file decoding is exact; ``run(path)`` and ``run_inference``
equal ``run_on_frames`` on the decoded frames exactly (the same code on the
same frames); ``extract_2d_tracks`` is held to the JAX LK tracker as
tests/test_torch_tracks.py holds the tracker (visibility agreement >= 99 %,
tracks within 1e-3 px on >= 95 % of the pairs both mark visible).
"""

import functools
import inspect
import json

import numpy as np
import pytest
import torch

from tdspa.features.tracks import extract_2d_tracks as jax_extract_2d_tracks
from tdspa.infer.checkpoint import save_checkpoint_npz
from tdspa.infer.video import load_video as jax_load_video
from tdspa.utils.synthetic_video import make_tracking_scene
from tdspa_torch.cli import infer as infer_cli
from tdspa_torch.features.depth import ConstantDepthProvider
from tdspa_torch.features.tracks import (
    PrecomputedTrackProvider,
    PyramidalLKTracker,
    StaticGridProvider,
    extract_2d_tracks,
)
from tdspa_torch.infer import pipeline as pipeline_lib
from tdspa_torch.infer.convert import params_to_flax
from tdspa_torch.infer.video import load_video, save_video
from tdspa_torch.utils.testing import tiny_model_3d

T, H, W, GRID = 8, 48, 64, 4


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A short mp4 written by the port's save_video, and its source frames."""
    video, _, _ = make_tracking_scene(num_frames=T, height=H, width=W, grid_size=GRID,
                                      sprite_size=16)
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    save_video(video, path, fps=24.0)
    return path, video


def _pipeline_kwargs():
    return dict(num_output_frames=T, use_dino=False, num_query_points=4, num_support_tracks=8,
                tracking_grid_size=GRID, depth_provider=ConstantDepthProvider(),
                model=tiny_model_3d(T, device="cpu", use_dino=False, seed=3), device="cpu")


def test_video_file_round_trip_equals_jax(clip):
    path, video = clip
    frames, fps = load_video(path)
    want, want_fps = jax_load_video(path)
    assert frames.dtype == np.uint8 and frames.shape == video.shape
    np.testing.assert_array_equal(frames, want)
    assert fps == want_fps == pytest.approx(24.0)
    # A lossy codec: close to the written frames, not equal.
    assert np.abs(frames.astype(np.float32) - video).mean() < 20.0
    capped, _ = load_video(path, max_frames=3)
    np.testing.assert_array_equal(capped, want[:3])
    with pytest.raises(ValueError, match="Could not open"):
        load_video(path + ".missing")


def test_run_and_run_inference_equal_run_on_frames(clip):
    path, _ = clip
    pipe = pipeline_lib.InferencePipeline(**_pipeline_kwargs())
    got = pipe.run(path)
    frames, fps = load_video(path, max_frames=T)
    want = pipe.run_on_frames(frames, fps)
    assert got["fps"] == pytest.approx(24.0)
    np.testing.assert_array_equal(got["video"], frames)
    for name in ("tracks", "visible_logits"):
        torch.testing.assert_close(getattr(got["predictions"], name),
                                   getattr(want["predictions"], name), rtol=0, atol=0)
    via_entry = pipeline_lib.run_inference(path, None, **_pipeline_kwargs())
    for name in ("tracks", "visible_logits"):
        torch.testing.assert_close(getattr(via_entry["predictions"], name),
                                   getattr(want["predictions"], name), rtol=0, atol=0)
    torch.testing.assert_close(via_entry["support_tracks"], want["support_tracks"], rtol=0, atol=0)


def test_extract_2d_tracks_matches_jax_lk(clip):
    _, video = clip
    want = jax_extract_2d_tracks(video, grid_size=GRID)  # no cotracker here: JAX's LK
    got = extract_2d_tracks(video, grid_size=GRID, device="cpu")
    got_tracks, got_vis = got["tracks"].numpy(), got["visible"].numpy()
    want_tracks, want_vis = np.asarray(want["tracks"]), np.asarray(want["visible"])
    assert got_tracks.shape == want_tracks.shape == (GRID * GRID, T, 2)
    assert got_vis.shape == want_vis.shape
    assert (got_vis == want_vis).mean() >= 0.99
    both = (got_vis[..., 0] > 0) & (want_vis[..., 0] > 0)
    err = np.abs(got_tracks - want_tracks).max(-1)
    assert (err[both] <= 1e-3).mean() >= 0.95
    static = extract_2d_tracks(video, provider=StaticGridProvider(GRID))
    assert static["tracks"].shape == (GRID * GRID, T, 2)


def test_entry_points_default_to_the_gpu():
    for fn in (extract_2d_tracks, pipeline_lib.InferencePipeline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert infer_cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_2d_tracks(np.zeros((2, 16, 16, 3), np.uint8), grid_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline_lib.run_inference("unused.mp4", None)


def _args(*flags):
    return infer_cli.build_parser().parse_args(["--video_path=v.mp4", *flags])


def test_infer_flags_become_pipeline_arguments(tmp_path):
    kw = infer_cli.pipeline_kwargs(_args("--device=cpu"))
    want_defaults = dict(
        checkpoint_path=None, num_output_frames=150, use_dino=True, use_depth=True,
        num_query_points=512, num_support_tracks=2048, tracking_grid_size=64,
        dino_model="facebook/dinov2-base", vda_encoder="vitb", track_provider=None,
        depth_provider=None, seed=0, projection_policy="error", quantize=False,
        residual_dtype=None, depth_output_scale=1.0, depth_input_size=518,
        gelu_approximate=False, tracking_input_scale=1.0, fused_block=False, tail_artifact=None,
        device="cpu",
    )
    assert kw == want_defaults
    pipeline_params = inspect.signature(pipeline_lib.InferencePipeline).parameters
    assert set(kw) <= set(pipeline_params)

    kw = infer_cli.pipeline_kwargs(_args(
        "--device=cpu", "--nouse_dino", "--use_depth=false", "--quantize", "--bf16_residual",
        "--fused_block=true", "--fast_gelu", "--num_output_frames", "12", "--seed=4",
        "--tracking_input_scale=0.5", "--projection_policy=slice", "--track_provider=lk",
        "--tracker_corr_radius=3", "--tracker_corr_rescue_level=1", "--tracker_matcher=auto",
        "--tracking_grid_size=8"))
    assert (kw["use_dino"], kw["use_depth"], kw["quantize"], kw["fused_block"]) == (
        False, False, True, True)
    assert kw["residual_dtype"] is torch.bfloat16 and kw["gelu_approximate"]
    assert (kw["num_output_frames"], kw["seed"], kw["projection_policy"]) == (12, 4, "slice")
    tracker = kw["track_provider"]
    assert isinstance(tracker, PyramidalLKTracker) and tracker.device.type == "cpu"
    assert (tracker.grid_size, tracker.corr_radius, tracker.corr_rescue_level, tracker.matcher,
            tracker.input_scale) == (8, 3, 1, "auto", 0.5)
    assert infer_cli.pipeline_kwargs(_args("--device=cpu", "--track_provider=lk")
                                     )["track_provider"].matcher is None
    assert isinstance(infer_cli.build_track_provider(_args("--track_provider=static"), "cpu"),
                      StaticGridProvider)
    npz = infer_cli.build_track_provider(_args(f"--track_provider=npz:{tmp_path}/t.npz"), "cpu")
    assert isinstance(npz, PrecomputedTrackProvider) and npz.npz_path == f"{tmp_path}/t.npz"

    for flag, missing in (("--track_provider=cotracker", "cotracker"),
                          ("--vda_torch_adapter", "Video-Depth-Anything")):
        with pytest.raises(NotImplementedError, match=missing):
            infer_cli.check_supported(_args(flag))
    infer_cli.check_supported(_args())
    # --debug_nans runs (tests/test_torch_debug.py).
    infer_cli.check_supported(_args("--debug_nans"))
    assert _args("--debug_nans").debug_nans and not _args().debug_nans
    # --tail_artifact runs (test_infer_cli_runs_an_exported_tail below).
    infer_cli.check_supported(_args("--tail_artifact=tail.pt2"))
    assert infer_cli.pipeline_kwargs(_args("--device=cpu", "--tail_artifact=tail.pt2")
                                     )["tail_artifact"] == "tail.pt2"
    with pytest.raises(SystemExit):
        _args("--projection_policy=other")
    with pytest.raises(ValueError, match="checkpoint_path"):
        infer_cli.main(["--video_path=v.mp4", "--device=cpu"])


def test_infer_cli_writes_the_reference_outputs(clip, tmp_path, monkeypatch):
    """One tiny end-to-end call: the full-size model is swapped for the tiny
    one (the CLI has no size flag), whose checkpoint JAX's
    save_checkpoint_npz writes."""
    path, _ = clip
    model = tiny_model_3d(T, device="cpu", use_dino=False, use_depth=False, seed=5)
    ckpt = tmp_path / "tiny.npz"
    save_checkpoint_npz(str(ckpt), params_to_flax(model.state_dict()))
    tiny = tiny_model_3d(T, device="cpu", use_dino=False, use_depth=False)
    monkeypatch.setattr(pipeline_lib, "InferencePipeline",
                        functools.partial(pipeline_lib.InferencePipeline, model=tiny))
    out_dir = tmp_path / "out"
    results = infer_cli.main([
        f"--video_path={path}", f"--checkpoint_path={ckpt}", f"--output_dir={out_dir}",
        f"--num_output_frames={T}", "--nouse_dino", "--nouse_depth", "--num_query_points=4",
        "--num_support_tracks=8", f"--tracking_grid_size={GRID}", "--device=cpu",
        f"--profile_dir={tmp_path}/trace",
    ])
    for name, param in model.state_dict().items():  # the checkpoint was loaded
        torch.testing.assert_close(tiny.state_dict()[name], param, rtol=0, atol=0)
    with np.load(out_dir / "predictions.npz") as saved:
        shapes = {k: saved[k].shape for k in saved.files}
        np.testing.assert_array_equal(saved["tracks_3d"],
                                      results["predictions"].tracks[0].numpy())
    assert shapes == {"tracks_3d": (4, T, 3), "visible_logits": (4, T, 1),
                      "query_tracks": (4, T, 3), "support_tracks": (8, T, 3)}
    info = (out_dir / "video_info.txt").read_text().splitlines()
    assert info == [f"FPS: {results['fps']}", f"Frames: {T}", "Query points: 4"]
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"tdspa.video.fused_tail", "tdspa.tail", "tdspa.model.encode_tracks"} <= names


def test_infer_cli_runs_an_exported_tail(clip, tmp_path, monkeypatch):
    """``--tail_artifact`` on the CPU: the tiny model's tail exported for the
    CLI's configuration (the tracker's 16 tracks, 8 support, 4 queries, no
    DINO) gives the traced tail's predictions exactly; an artifact exported
    for another query count is refused."""
    from tdspa_torch.infer.export import export_serving_tail, save_exported, tail_config

    path, _ = clip
    model = tiny_model_3d(T, device="cpu", use_dino=False, use_depth=False, seed=5)
    ckpt = tmp_path / "tiny.npz"
    save_checkpoint_npz(str(ckpt), params_to_flax(model.state_dict()))
    monkeypatch.setattr(pipeline_lib, "InferencePipeline", functools.partial(
        pipeline_lib.InferencePipeline,
        model=tiny_model_3d(T, device="cpu", use_dino=False, use_depth=False)))
    flags = [f"--video_path={path}", f"--checkpoint_path={ckpt}", f"--num_output_frames={T}",
             "--nouse_dino", "--nouse_depth", "--num_query_points=4", "--num_support_tracks=8",
             f"--tracking_grid_size={GRID}", "--device=cpu"]
    for queries in (4, 3):
        shapes = dict(num_tracks=GRID ** 2, num_frames=T, video_hw=(H, W), num_support=8,
                      num_queries=queries, use_dino=False, use_depth=False)
        artifact = str(tmp_path / f"tail_{queries}.pt2")
        save_exported(export_serving_tail(model, device="cpu", **shapes), artifact,
                      tail_config(model, device="cpu", **shapes))
    want = infer_cli.main(flags + [f"--output_dir={tmp_path}/eager"])
    got = infer_cli.main(flags + [f"--output_dir={tmp_path}/artifact",
                                  f"--tail_artifact={tmp_path}/tail_4.pt2"])
    for name in ("tracks", "visible_logits"):
        torch.testing.assert_close(getattr(got["predictions"], name),
                                   getattr(want["predictions"], name), rtol=0, atol=0)
    with np.load(tmp_path / "artifact" / "predictions.npz") as saved:
        np.testing.assert_array_equal(saved["tracks_3d"], want["predictions"].tracks[0].numpy())
    with pytest.raises(ValueError, match="num_queries"):
        infer_cli.main(flags + [f"--output_dir={tmp_path}/x",
                                f"--tail_artifact={tmp_path}/tail_3.pt2"])
