"""tdspa_torch's inference tail against tdspa's: geometry ops, the
support/query split, fused_tail, InferencePipeline.run_on_frames,
save_results and checkpoint loading, on a tiny model.

The split's indices are drawn from JAX's key and injected into the port
(torch cannot reproduce the jax.random stream; see data/batch_prep.py).
f32 holds at 2e-5; the bf16 pipeline (kernels off on the CPU on both sides)
at 5e-2 of the outputs' range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tdspa.data.batch_prep import split_and_sample_queries as jax_split
from tdspa.features.depth import ConstantDepthProvider as JaxConstantDepth
from tdspa.features.tracks import StaticGridProvider as JaxStaticGrid
from tdspa.infer import checkpoint as jax_checkpoint
from tdspa.infer.pipeline import InferencePipeline as JaxPipeline
from tdspa.infer.pipeline import fused_tail as jax_fused_tail
from tdspa.ops import geometry as jgeo
from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
from tdspa_torch.data.batch_prep import split_and_sample_queries
from tdspa_torch.features.depth import ConstantDepthProvider
from tdspa_torch.features.tracks import (
    PrecomputedTrackProvider,
    StaticGridProvider,
    make_query_grid,
)
from tdspa_torch.infer import checkpoint
from tdspa_torch.infer.convert import params_from_flax, params_to_flax
from tdspa_torch.infer.pipeline import InferencePipeline, fused_tail, save_results
from tdspa_torch.ops import geometry
from tdspa_torch.parallel.mesh import make_mesh
from tdspa_torch.utils.testing import tiny_model_3d

T, H, W = 10, 32, 40
F32_TOL = dict(rtol=2e-5, atol=2e-5)
NUM_SUPPORT, NUM_QUERIES = 10, 6


def _video():
    return np.random.default_rng(0).integers(0, 255, (T, H, W, 3)).astype(np.uint8)


def _dino_grid():
    return np.random.default_rng(1).standard_normal((T, 3, 3, 768)).astype(np.float32)


def _tracks(n=16, seed=2):
    """Moving tracks, some outside the frame (corner clamping)."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-3, W + 3, (n, T)), rng.uniform(-3, H + 3, (n, T))], -1)
    return xy.astype(np.float32), (rng.uniform(size=(n, T, 1)) > 0.2).astype(np.float32)


def _jax_split_indices(num_tracks, num_queries, seed=0):
    """The permutation and query frames JAX's split draws from PRNGKey(seed)."""
    k_perm, k_frames = jax.random.split(jax.random.PRNGKey(seed))
    perm = np.asarray(jax.random.permutation(k_perm, num_tracks))
    ts = np.asarray(jax.random.randint(k_frames, (num_queries,), 0, T))
    return torch.from_numpy(perm.astype(np.int64)), torch.from_numpy(ts.astype(np.int64))


def _tiny_params(seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params_to_flax(tiny_model_3d(T, device="cpu", seed=seed).state_dict()),
    )


def test_bilinear_sample_matches_jax_out_of_range():
    grid = np.random.default_rng(4).standard_normal((T, 7, 9, 5)).astype(np.float32)
    coords = np.stack([np.random.default_rng(5).uniform(-4, 13, (11, T)),
                       np.random.default_rng(6).uniform(-4, 11, (11, T))], -1).astype(np.float32)
    want = jgeo.bilinear_sample(jnp.asarray(grid), jnp.asarray(coords))
    got = geometry.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_lift_and_feature_samplers_match_jax():
    tracks, _ = _tracks()
    depth = (1 + np.random.default_rng(7).uniform(size=(T, H, W, 1))).astype(np.float32)
    dino = _dino_grid()
    jt, jd = jnp.asarray(tracks), jnp.asarray(depth)
    tt, td = torch.from_numpy(tracks), torch.from_numpy(depth)
    pairs = [
        (jgeo.lift_2d_to_3d(jt, jd), geometry.lift_2d_to_3d(tt, td)),
        (jgeo.sample_depth_features_for_tracks(jd, jt),
         geometry.sample_depth_features_for_tracks(td, tt)),
        (jgeo.sample_dino_features_for_tracks(jnp.asarray(dino), jt, (T, H, W, 3)),
         geometry.sample_dino_features_for_tracks(torch.from_numpy(dino), tt, (T, H, W, 3))),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_split_with_injected_jax_indices_matches_jax():
    tracks, visible = _tracks()
    tracks3 = np.concatenate([tracks, np.ones_like(tracks[..., :1])], -1)
    feats = np.random.default_rng(8).standard_normal((16, T, 4)).astype(np.float32)
    want = jax_split(jax.random.PRNGKey(0), jnp.asarray(tracks3), jnp.asarray(visible),
                     NUM_SUPPORT, NUM_QUERIES, T, dino_features=jnp.asarray(feats),
                     depth_features=jnp.asarray(feats))
    perm, ts = _jax_split_indices(16, NUM_QUERIES)
    got = split_and_sample_queries(perm, ts, torch.from_numpy(tracks3), torch.from_numpy(visible),
                                   NUM_SUPPORT, NUM_QUERIES, T, dino_features=torch.from_numpy(feats),
                                   depth_features=torch.from_numpy(feats))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("use_depth", [True, False])
def test_fused_tail_matches_jax(use_depth):
    tracks, visible = _tracks()
    depth = (1 + np.random.default_rng(9).uniform(size=(T, H, W, 1))).astype(np.float32)
    params = _tiny_params()
    jmodel = jax_tiny_model_3d(T, use_depth=use_depth)
    want_pred, want_batch, want_3d = jax_fused_tail(
        params, jnp.asarray(tracks), jnp.asarray(visible), jnp.asarray(_dino_grid()),
        jnp.asarray(depth), jax.random.PRNGKey(0), jmodel, NUM_SUPPORT, NUM_QUERIES, (H, W),
        True, use_depth,
    )
    model = tiny_model_3d(T, device="cpu", use_depth=use_depth)
    model.load_state_dict({k: v for k, v in params_from_flax(params).items()
                           if use_depth or not k.startswith("depth_projection")})
    perm, ts = _jax_split_indices(16, NUM_QUERIES)
    with torch.no_grad():
        pred, batch, tracks_3d = fused_tail(
            model, torch.from_numpy(tracks), torch.from_numpy(visible),
            torch.from_numpy(_dino_grid()), torch.from_numpy(depth), perm, ts,
            NUM_SUPPORT, NUM_QUERIES, (H, W), True, use_depth,
        )
    np.testing.assert_allclose(tracks_3d.numpy(), np.asarray(want_3d), **F32_TOL)
    np.testing.assert_allclose(batch["query_points"].numpy(), np.asarray(want_batch["query_points"]),
                               **F32_TOL)
    for name in ("tracks", "visible_logits"):
        np.testing.assert_allclose(getattr(pred, name).numpy(),
                                   np.asarray(getattr(want_pred, name)), **F32_TOL)


def _pipelines(dtype, jax_params, **kwargs):
    jdtype, tdtype = dtype
    jax_pipe = JaxPipeline(
        num_output_frames=T, num_query_points=NUM_QUERIES, num_support_tracks=NUM_SUPPORT,
        track_provider=JaxStaticGrid(grid_size=4), depth_provider=JaxConstantDepth(),
        dino_extractor=lambda video: _dino_grid(), params=jax_params, dtype=jdtype,
        model=jax_tiny_model_3d(T, dtype=jdtype, fused_attention=jdtype == jnp.bfloat16),
    )
    pipe = InferencePipeline(
        num_output_frames=T, num_query_points=NUM_QUERIES, num_support_tracks=NUM_SUPPORT,
        track_provider=StaticGridProvider(grid_size=4), depth_provider=ConstantDepthProvider(),
        dino_extractor=lambda video: _dino_grid(), dtype=tdtype,
        model=tiny_model_3d(T, device="cpu", dtype=tdtype,
                            fused_attention=tdtype == torch.bfloat16),
        device="cpu", **kwargs,
    )
    pipe.split_indices = lambda num_tracks, num_queries, num_frames: _jax_split_indices(
        num_tracks, num_queries, seed=0)
    return jax_pipe, pipe


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_run_on_frames_matches_jax_pipeline(precision):
    dtype = (jnp.float32, torch.float32) if precision == "f32" else (jnp.bfloat16, torch.bfloat16)
    params = _tiny_params()
    jax_pipe, pipe = _pipelines(dtype, params, params=params)
    want, got = jax_pipe.run_on_frames(_video()), pipe.run_on_frames(_video())
    scale = float(np.abs(np.asarray(want["predictions"].tracks)).max())
    tol = F32_TOL if precision == "f32" else dict(rtol=0, atol=5e-2 * scale)
    for name in ("tracks", "visible_logits", "certain_logits"):
        np.testing.assert_allclose(getattr(got["predictions"], name).float().numpy(),
                                   np.asarray(getattr(want["predictions"], name), np.float32),
                                   **tol, err_msg=name)
    for key in ("tracks_3d", "support_tracks", "query_tracks"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **F32_TOL)
    assert set(got["timings"]) >= {"video_upload", "tracking", "dino_features", "depth",
                                   "fused_tail"}


def test_save_results_schema(tmp_path):
    _, pipe = _pipelines((jnp.float32, torch.float32), _tiny_params())
    results = pipe.run_on_frames(_video())
    save_results(results, str(tmp_path))
    with np.load(tmp_path / "predictions.npz") as data:
        assert set(data.files) == {"tracks_3d", "visible_logits", "query_tracks", "support_tracks"}
        assert data["tracks_3d"].shape == (NUM_QUERIES, T, 3)
        assert data["visible_logits"].shape == (NUM_QUERIES, T, 1)
        assert data["support_tracks"].shape == (NUM_SUPPORT, T, 3)
    info = (tmp_path / "video_info.txt").read_text()
    assert info == f"FPS: 30.0\nFrames: {T}\nQuery points: {NUM_QUERIES}\n"


def test_split_indices_are_seeded_and_cover_the_tracks():
    pipe = InferencePipeline(model=tiny_model_3d(T, device="cpu"), device="cpu", seed=5)
    perm, ts = pipe.split_indices(16, NUM_QUERIES, T)
    again, ts_again = pipe.split_indices(16, NUM_QUERIES, T)
    assert torch.equal(perm, again) and torch.equal(ts, ts_again)
    assert sorted(perm.tolist()) == list(range(16))
    assert ts.shape == (NUM_QUERIES,) and 0 <= int(ts.min()) and int(ts.max()) < T


@pytest.mark.parametrize("layout", ["flat", "params", "optimizer"])
def test_checkpoint_written_by_jax_gives_the_same_outputs(tmp_path, layout):
    params = _tiny_params()
    path = str(tmp_path / "ckpt.npz")
    if layout == "flat":
        jax_checkpoint.save_checkpoint_npz(path, params)
    elif layout == "params":
        np.savez(path, params=np.array(params, dtype=object))
    else:
        np.savez(path, optimizer=np.array({"target": params}, dtype=object))
    jax_pipe, _ = _pipelines((jnp.float32, torch.float32), params)
    _, pipe = _pipelines((jnp.float32, torch.float32), None, checkpoint_path=path)
    want, got = jax_pipe.run_on_frames(_video()), pipe.run_on_frames(_video())
    np.testing.assert_allclose(got["predictions"].tracks.numpy(),
                               np.asarray(want["predictions"].tracks), **F32_TOL)


def _square_projection_tree():
    params = _tiny_params()
    rng = np.random.default_rng(10)
    params["dino_projection"] = {"kernel": rng.standard_normal((768, 768)).astype(np.float32),
                                 "bias": rng.standard_normal(768).astype(np.float32)}
    params["depth_projection"] = {"kernel": rng.standard_normal((256, 256)).astype(np.float32),
                                  "bias": rng.standard_normal(256).astype(np.float32)}
    return params


def test_projection_policy_error_slice_ignore_match_jax(tmp_path):
    path = str(tmp_path / "ref.npz")
    jax_checkpoint.save_checkpoint_npz(path, _square_projection_tree())
    with pytest.raises(ValueError, match="projection_policy='slice'"):
        checkpoint.load_params_tree(path, track_token_dim=16)
    got = checkpoint.load_params_tree(path, projection_policy="slice", track_token_dim=16)
    want = jax_checkpoint.load_checkpoint(path, projection_policy="slice", track_token_dim=16)
    for name in ("dino_projection", "depth_projection"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf], want[name][leaf])
    assert got["dino_projection"]["kernel"].shape == (768, 16)
    ignored = checkpoint.load_params_tree(path, projection_policy="ignore", track_token_dim=16)
    assert ignored["depth_projection"]["kernel"].shape == (256, 256)
    with pytest.raises(ValueError, match="Unknown projection_policy"):
        checkpoint.adapt_reference_projections({}, policy="bogus")
    # The sliced checkpoint loads into the tiny model.
    state = checkpoint.load_checkpoint(path, projection_policy="slice", track_token_dim=16,
                                       device="cpu")
    tiny_model_3d(T, device="cpu").load_state_dict(state)


def test_load_checkpoint_returns_a_state_dict_on_the_device(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    params = _tiny_params()
    jax_checkpoint.save_checkpoint_npz(path, params)
    state = checkpoint.load_checkpoint(path, device="cpu")
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in state.values())
    assert state.keys() == tiny_model_3d(T, device="cpu").state_dict().keys()
    np.testing.assert_array_equal(state["compressor.kernel"].numpy(), params["compressor"]["kernel"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checkpoint.load_checkpoint(path)


def test_check_params_structure_reports_like_jax():
    expected = params_to_flax(tiny_model_3d(T, device="cpu").state_dict())
    actual = jax.tree_util.tree_map(lambda x: x, expected)
    del actual["compressor"]["bias"]
    actual["compressor"]["extra"] = np.zeros(2)
    actual["decompressor"]["kernel"] = np.zeros((3, 3))
    assert checkpoint.check_params_structure(expected, actual) == \
        jax_checkpoint.check_params_structure(expected, actual)
    assert len(checkpoint.check_params_structure(expected, actual)) == 3


def test_pipeline_refuses_what_later_slices_bring(tmp_path):
    model = tiny_model_3d(T, device="cpu")
    # A mesh runs the sharded tail (tests/test_torch_parallel.py at two
    # ranks); on a one-rank gloo group it gives the unsharded pipeline's
    # outputs, with rank 0's split.
    def pipeline(**kw):
        return InferencePipeline(model=model, device="cpu", num_output_frames=T,
                                 track_provider=StaticGridProvider(grid_size=4),
                                 depth_provider=ConstantDepthProvider(), use_dino=False, **kw)

    want = pipeline().run_on_frames(_video())
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        got = pipeline(mesh=make_mesh()).run_on_frames(_video())
    finally:
        dist.destroy_process_group()
    for name in ("tracks", "visible_logits"):
        np.testing.assert_array_equal(getattr(got["predictions"], name).numpy(),
                                      getattr(want["predictions"], name).numpy())
    np.testing.assert_array_equal(got["tracks_3d"].numpy(), want["tracks_3d"].numpy())
    # Exported tails run (tests/test_torch_export.py); the artifact is read
    # at the first run, so a missing one is refused there.
    pipe = InferencePipeline(model=model, device="cpu", tracking_grid_size=4,
                             tail_artifact=str(tmp_path / "tail.pt2"), use_dino=False,
                             depth_provider=ConstantDepthProvider())
    assert pipe.tail_artifact == str(tmp_path / "tail.pt2")
    with pytest.raises(FileNotFoundError):
        pipe.run_on_frames(_video())
    # DINO and depth are the port's own now (test below), and so is decoding
    # a video file (tests/test_torch_video.py): a missing file is refused.
    pipe = InferencePipeline(model=model, device="cpu", tracking_grid_size=4)
    with pytest.raises(ValueError, match="Could not open video file"):
        pipe.run(str(tmp_path / "video.mp4"))


# The lazily built front ends at tiny size: a one-layer DINO ViT of the
# tail's feature width (768) and the tiny depth estimator of
# tests/test_torch_depth.py in 2-frame groups, both f32.
TINY_DINO = dict(hidden_size=768, num_layers=1, num_heads=12, patch_size=14, image_size=28)
TINY_DEPTH = dict(hidden_size=32, num_layers=4, num_heads=2, patch_size=14, image_size=28)
TINY_HEAD = {"features": 16, "out_channels": [8, 16, 24, 32], "layer_idxs": [0, 1, 2, 3]}
# Streamed vs whole on the CPU: the same f32 arithmetic on the same frames;
# only the resizes' and DINO's products run on other batch sizes.
STREAM_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture
def tiny_front_ends(monkeypatch):
    """The pipeline's default DINO and depth classes, built tiny; records the
    keyword arguments the pipeline builds them with."""
    from tdspa_torch.features import dino as dino_lib
    from tdspa_torch.features.vit import ViTConfig
    from tdspa_torch.infer import pipeline as pipeline_lib

    built = {}

    class TinyDino(pipeline_lib.DinoFeatureExtractor):
        def __init__(self, **kwargs):
            built["dino"] = kwargs
            super().__init__(vit_config=ViTConfig(**TINY_DINO), dtype=torch.float32,
                             **kwargs)

    class TinyDepth(pipeline_lib.VideoDepthEstimator):
        def __init__(self, **kwargs):
            built["depth"] = kwargs
            super().__init__(vit_config=ViTConfig(**TINY_DEPTH), head_cfg=TINY_HEAD,
                             dtype=torch.float32, frame_chunk=2, **kwargs)

    monkeypatch.setattr(dino_lib, "load_dinov2_params", lambda name, config: None)
    monkeypatch.setattr(pipeline_lib, "DinoFeatureExtractor", TinyDino)
    monkeypatch.setattr(pipeline_lib, "VideoDepthEstimator", TinyDepth)
    return built


def _recording_pipeline(**kwargs):
    """A CPU pipeline with the default tracker (4x4 grid) whose track_chunks
    keeps the device video the streamed stages saw."""
    pipe = InferencePipeline(num_output_frames=T, num_query_points=NUM_QUERIES,
                             num_support_tracks=NUM_SUPPORT, tracking_grid_size=4,
                             model=tiny_model_3d(T, device="cpu"), device="cpu", **kwargs)
    captured = {}
    track_chunks = pipe.track_provider.track_chunks

    def recording(chunks):
        captured["video"] = torch.cat(chunks, dim=0)
        return track_chunks(chunks)

    pipe.track_provider.track_chunks = recording
    return pipe, captured


def test_default_front_ends_are_built_lazily_and_streamed(tiny_front_ends):
    """No providers passed: the port's DINO and depth stages, built with the
    pipeline's knobs, run per upload chunk (4, 4, 2 frames); their parts
    concatenated equal one whole-video call; the whole video is not kept."""
    pipe, captured = _recording_pipeline(
        upload_chunk_frames=4, residual_dtype=torch.float32, gelu_approximate=True,
        depth_output_scale=0.5, depth_input_size=28, dino_model="facebook/dinov2-small",
        vda_encoder="vitb")
    results = pipe.run_on_frames(_video())
    assert tiny_front_ends["dino"] == dict(
        model_name="facebook/dinov2-small", residual_dtype=torch.float32, gelu_approximate=True,
        device=torch.device("cpu"))
    assert tiny_front_ends["depth"] == dict(
        encoder="vitb", residual_dtype=torch.float32, output_scale=0.5, input_size=28,
        gelu_approximate=True, device=torch.device("cpu"))
    assert set(results["timings"]) == {"upload_tracking_features", "fused_tail"}
    assert results["dino_grid"].shape == (T, 2, 2, 768)
    assert results["depth"].shape == (T, H, W, 1) and bool((results["depth"] >= 0).all())
    torch.testing.assert_close(results["dino_grid"], pipe.dino_extractor(captured["video"]),
                               **STREAM_TOL)
    torch.testing.assert_close(results["depth"], pipe.depth_provider(captured["video"]),
                               **STREAM_TOL)
    assert torch.isfinite(results["predictions"].tracks).all()
    _, video_dev, dino_grid, depth_maps = pipe._streamed_upload_and_tracking(_video())
    assert video_dev is None and dino_grid is not None and depth_maps is not None


@pytest.mark.parametrize("chunk,given_dino", [(3, False), (4, True)],
                         ids=["chunks_off_the_depth_groups", "dino_passed_in"])
def test_only_aligned_own_stages_stream(tiny_front_ends, chunk, given_dino):
    """Depth streams only when the chunk is a multiple of its 2-frame groups
    (3 is not: it runs once on the whole video); a DINO provider passed in
    is not streamed and takes the whole device video (``need_full``)."""
    seen = []

    def dino_provider(video):
        seen.append(tuple(video.shape))
        return _dino_grid()

    pipe, captured = _recording_pipeline(
        upload_chunk_frames=chunk, depth_input_size=28,
        dino_extractor=dino_provider if given_dino else None)
    results = pipe.run_on_frames(_video())
    streamed_depth = chunk % 2 == 0
    assert ("depth" in results["timings"]) is not streamed_depth
    assert ("dino_features" in results["timings"]) is given_dino
    assert seen == ([(T, H, W, 3)] if given_dino else [])
    torch.testing.assert_close(results["depth"], pipe.depth_provider(captured["video"]),
                               **STREAM_TOL)
    if not given_dino:
        torch.testing.assert_close(results["dino_grid"], pipe.dino_extractor(captured["video"]),
                                   **STREAM_TOL)
    _, video_dev, _, _ = pipe._streamed_upload_and_tracking(_video())
    assert video_dev is not None and video_dev.shape == (T, H, W, 3)


def test_host_providers_match_jax(tmp_path):
    np.testing.assert_array_equal(make_query_grid(8, 16, 2), [[4, 2], [12, 2], [4, 6], [12, 6]])
    video = _video()
    want, got = JaxStaticGrid(4)(video), StaticGridProvider(4)(video)
    for key in ("tracks", "visible"):
        np.testing.assert_array_equal(got[key], want[key])
    np.savez(tmp_path / "tracks.npz", tracks=want["tracks"], visible=want["visible"][..., 0])
    loaded = PrecomputedTrackProvider(str(tmp_path / "tracks.npz"))(video)
    assert loaded["visible"].shape == (16, T, 1)
    np.testing.assert_array_equal(ConstantDepthProvider()(video), JaxConstantDepth()(video))


@pytest.mark.parametrize("knob", ["quantize", "fused_block"])
def test_serving_knob_reaches_the_model_and_matches_jax(knob, monkeypatch):
    """``InferencePipeline(quantize=True)`` / ``(fused_block=True)``: the knob
    reaches the model the pipeline builds (built tiny here, head width 32 so
    that the block kernel takes the decompress and readout stacks), and
    run_on_frames matches the JAX pipeline in the same configuration at f32
    (JAX's kernels in interpret mode): 2e-5, the f32 tolerance."""
    from tdspa.kernels import attention as jax_kernels
    from tdspa_torch.infer import pipeline as pipeline_lib

    monkeypatch.setattr(jax_kernels, "INTERPRET_DEFAULT", True)
    tiny = dict(qkv_size=64, **{knob: True})
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params_to_flax(tiny_model_3d(T, device="cpu", seed=3, qkv_size=64).state_dict()),
    )
    built = {}

    def tiny_model(num_output_frames, use_dino, use_depth, dtype, fused_attention, quantize,
                   residual_dtype, fused_block, device, seed):
        built.update(quantize=quantize, fused_block=fused_block)
        return tiny_model_3d(num_output_frames, device=device, dtype=dtype,
                             fused_attention=fused_attention, residual_dtype=residual_dtype,
                             **tiny)

    monkeypatch.setattr(pipeline_lib, "TrackAutoEncoder3D", tiny_model)
    pipe = InferencePipeline(
        num_output_frames=T, num_query_points=NUM_QUERIES, num_support_tracks=NUM_SUPPORT,
        track_provider=StaticGridProvider(grid_size=4), depth_provider=ConstantDepthProvider(),
        dino_extractor=lambda video: _dino_grid(), dtype=torch.float32, params=params,
        device="cpu", **{knob: True},
    )
    pipe.split_indices = lambda num_tracks, num_queries, num_frames: _jax_split_indices(
        num_tracks, num_queries, seed=0)
    assert built == {"quantize": knob == "quantize", "fused_block": knob == "fused_block"}
    jax_pipe = JaxPipeline(
        num_output_frames=T, num_query_points=NUM_QUERIES, num_support_tracks=NUM_SUPPORT,
        track_provider=JaxStaticGrid(grid_size=4), depth_provider=JaxConstantDepth(),
        dino_extractor=lambda video: _dino_grid(), params=params, dtype=jnp.float32,
        model=jax_tiny_model_3d(T, **tiny), **{knob: True},
    )
    want, got = jax_pipe.run_on_frames(_video()), pipe.run_on_frames(_video())
    for name in ("tracks", "visible_logits"):
        np.testing.assert_allclose(getattr(got["predictions"], name).numpy(),
                                   np.asarray(getattr(want["predictions"], name)), **F32_TOL,
                                   err_msg=name)
