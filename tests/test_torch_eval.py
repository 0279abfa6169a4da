"""tdspa_torch's evaluation modules against tdspa's: the TAPVid-3D metrics
(a numpy copy: equal), the realism scorer and its visualisation file, the
harness (bucketing, batching, metrics), ``NpzDirectoryProvider`` and the
evaluate CLI, with the tiny 3D model in f32 on both sides.

Tolerances: the metrics copy is exact. The scorer's outputs hold at 1e-5
(the f32 forward differs from flax's by summation order only, 2e-5 in
tests/test_torch_model.py, and the scores are smooth in it). Harness
metrics hold at 1e-4. They threshold the predictions: no visibility logit
of these inputs lies within 1e-4 (five times the forward's error) of 0
(``_assert_no_pair_near_a_threshold``), so no occlusion flag can flip; a
flipped distance flag would move a metric by a whole (point, frame) pair's
share (at least 1/300 here), so agreement at 1e-4 shows that none flipped.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.data.providers import NpzDirectoryProvider as JaxNpzProvider
from tdspa.eval import harness as jax_harness
from tdspa.eval import tapvid3d_metrics as jax_metrics
from tdspa.eval.realism import save_visualization_npz as jax_save_viz
from tdspa.eval.realism import score_tracks as jax_score_tracks
from tdspa.infer.checkpoint import save_checkpoint_npz
from tdspa.utils.testing import synthetic_batch as jax_synthetic_batch
from tdspa.utils.testing import tiny_model_3d as jax_tiny_model_3d
from tdspa_torch.cli import evaluate as evaluate_cli
from tdspa_torch.data.providers import NpzDirectoryProvider
from tdspa_torch.eval import harness, tapvid3d_metrics
from tdspa_torch.eval.realism import save_visualization_npz, score_tracks
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.utils.testing import tiny_model_3d

T = 12
HARNESS_ATOL = 1e-4
SCORE_ATOL = 1e-5
BATCHED_ATOL = 0.02


def _gt_example(n=10, t=T, seed=0):
    """tests/integration/test_eval_harness.py's synthetic ground truth."""
    rng = np.random.default_rng(seed)
    tracks = rng.normal(size=(n, t, 3)).astype(np.float32) + [0, 0, 5.0]
    visible = (rng.uniform(size=(n, t, 1)) > 0.2).astype(np.float32)
    qf = rng.integers(0, t, size=n)
    queries_xyt = np.stack(
        [rng.uniform(0, 64, n), rng.uniform(0, 64, n), qf.astype(np.float64)], axis=1,
    ).astype(np.float32)
    return {
        "tracks_3d": tracks.astype(np.float32),
        "visible": visible,
        "queries_xyt": queries_xyt,
        "intrinsics": np.array([100.0, 100.0, 32.0, 32.0], np.float32),
    }


@pytest.fixture(scope="module")
def models():
    """JAX's tiny harness model, its JAX-initialised parameters, and the
    port's tiny model holding them."""
    jmodel = jax_tiny_model_3d(T, use_dino=False, use_depth=False)
    batch, _ = jax_harness.build_eval_batch(_gt_example(), num_output_frames=T, track_bucket=8)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tiny_model_3d(T, use_dino=False, use_depth=False, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("order", ["t n", "n t"])
@pytest.mark.parametrize("scaling", ["median", "per_trajectory", "none"])
def test_tapvid3d_metrics_equal_jax(scaling, order):
    rng = np.random.default_rng(3)
    n, t = 9, 7
    shape = (t, n) if order == "t n" else (n, t)
    gt = rng.normal(size=shape + (3,)) + [0, 0, 4.0]
    pred = gt * rng.uniform(0.7, 1.3) + 0.05 * rng.normal(size=gt.shape)
    gt_occ, pred_occ = rng.uniform(size=shape) < 0.25, rng.uniform(size=shape) < 0.25
    qp = np.stack([rng.integers(0, t, n), rng.uniform(0, 64, n), rng.uniform(0, 64, n)], axis=1)
    args = (gt_occ, gt, pred_occ, pred, np.array([90.0, 110.0, 32.0, 30.0]))
    kw = dict(scaling=scaling, query_points=qp, order=order)
    want = jax_metrics.compute_tapvid3d_metrics(*args, **kw)
    assert tapvid3d_metrics.compute_tapvid3d_metrics(*args, **kw) == want
    assert tapvid3d_metrics.zero_metrics() == jax_metrics.zero_metrics()
    assert tapvid3d_metrics.TAPNET_AVAILABLE == jax_metrics.TAPNET_AVAILABLE


def test_tapvid3d_fixed_threshold_equals_jax(monkeypatch):
    """``use_fixed_metric_threshold``: equal to JAX's copy; the tapnet branch,
    which is not handed the option, refuses it."""
    rng = np.random.default_rng(4)
    n, t = 9, 7
    gt = rng.normal(size=(n, t, 3)) + [0, 0, 4.0]
    pred = gt + 0.5 * rng.normal(size=gt.shape)  # thresholds of 1-16 m: some miss
    gt_occ, pred_occ = rng.uniform(size=(n, t)) < 0.25, rng.uniform(size=(n, t)) < 0.25
    qp = np.stack([rng.integers(0, t, n), rng.uniform(0, 64, n), rng.uniform(0, 64, n)], axis=1)
    args = (gt_occ, gt, pred_occ, pred, np.array([90.0, 110.0, 32.0, 30.0]))
    kw = dict(scaling="none", query_points=qp, order="n t", use_fixed_metric_threshold=True)
    want = jax_metrics.compute_tapvid3d_metrics(*args, **kw)
    got = tapvid3d_metrics.compute_tapvid3d_metrics(*args, **kw)
    assert got == want
    assert got != tapvid3d_metrics.compute_tapvid3d_metrics(
        *args, **{**kw, "use_fixed_metric_threshold": False})
    monkeypatch.setattr(tapvid3d_metrics, "TAPNET_AVAILABLE", True)
    with pytest.raises(ValueError, match="use_fixed_metric_threshold"):
        tapvid3d_metrics.compute_tapvid3d_metrics(*args, **kw)


def test_score_tracks_matches_jax(models, tmp_path):
    jmodel, params, tmodel = models
    batch = jax.tree_util.tree_map(
        np.asarray, jax_synthetic_batch(jax.random.PRNGKey(0), batch=1, num_queries=5,
                                        num_frames=T))
    want = jax_score_tracks(jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = score_tracks(tmodel, None, batch)
    assert set(got) == set(want)
    for key in ("coords_score", "point_error"):
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SCORE_ATOL, err_msg=key)
    assert got["coords_score"].shape == (T, 5)
    for key in ("realism_score", "mean_error", "visible_agreement"):
        assert isinstance(got[key], float)
        assert got[key] == pytest.approx(want[key], abs=SCORE_ATOL), key
    # Loading the flax tree through ``params`` gives the same scores.
    again = score_tracks(tiny_model_3d(T, use_dino=False, use_depth=False, device="cpu"),
                         params, batch)
    np.testing.assert_array_equal(again["point_error"], got["point_error"])

    rng = np.random.default_rng(0)
    viz = dict(coords=rng.normal(size=(4, 6, 3)), coords_score=got["coords_score"][:4, :6],
               video=rng.integers(0, 255, (4, 16, 16, 3)).astype(np.uint8),
               visibs=np.ones((4, 6)))
    jax_save_viz(str(tmp_path / "jax.npz"), **viz)
    save_visualization_npz(str(tmp_path / "port.npz"),
                           **{k: torch.as_tensor(v) if k == "coords" else v
                              for k, v in viz.items()})
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_bucketing_and_batch_equal_jax():
    ex = _gt_example(n=10, t=7)
    qp = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    want = jax_harness.pad_example_to_bucket(ex["tracks_3d"], ex["visible"], qp, T, 8)
    got = harness.pad_example_to_bucket(ex["tracks_3d"], ex["visible"], qp, T, 8)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] == 7

    for example in (ex, {**_gt_example(n=20), "fx_fy_cx_cy": ex["intrinsics"]}):
        if "fx_fy_cx_cy" in example:
            del example["intrinsics"]
        jbatch, jmeta = jax_harness.build_eval_batch(example, num_output_frames=T, track_bucket=8)
        tbatch, tmeta = harness.build_eval_batch(example, num_output_frames=T, track_bucket=8)
        assert sorted(tbatch) == sorted(jbatch)
        for key in jbatch:
            np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(jbatch[key]), key)
        assert tmeta["num_tracks"] == jmeta["num_tracks"]
        assert tmeta["num_frames"] == jmeta["num_frames"]
        np.testing.assert_array_equal(tmeta["queries_xyt"], jmeta["queries_xyt"])


def _assert_metrics_close(got, want, atol=HARNESS_ATOL):
    assert set(got) == set(want)
    for scaling in want:
        assert set(got[scaling]) == set(want[scaling])
        for key, value in want[scaling].items():
            assert got[scaling][key] == pytest.approx(value, abs=atol), (scaling, key)


def _assert_no_pair_near_a_threshold(tmodel, examples, margin=1e-4):
    """No visibility logit within ``margin`` of 0: the forward agrees with
    flax's to 2e-5, so no occlusion flag can flip."""
    for example in examples:
        batch, meta = harness.build_eval_batch(example, num_output_frames=T, track_bucket=8)
        with torch.no_grad():
            logits = tmodel(batch).visible_logits[0, : meta["num_tracks"], : meta["num_frames"]]
        assert logits.abs().min().item() > margin


def test_evaluate_video_and_batched_model_match_jax(models):
    jmodel, params, tmodel = models
    examples = [_gt_example(seed=i) for i in range(5)] + [
        _gt_example(n=20, seed=10 + i) for i in range(2)
    ]
    _assert_no_pair_near_a_threshold(tmodel, examples)
    scalings = ("median", "per_trajectory")
    per_video = []
    for ex in examples[:2]:
        want = jax_harness.evaluate_video(params, ex, num_output_frames=T, depth_scalings=scalings,
                                          track_bucket=8, model=jmodel)
        got = harness.evaluate_video(params, ex, num_output_frames=T, depth_scalings=scalings,
                                     track_bucket=8, model=tmodel, device="cpu")
        _assert_metrics_close(got, want)
    for ex in examples:
        per_video.append(harness.evaluate_video(None, ex, num_output_frames=T,
                                                depth_scalings=("median",), track_bucket=8,
                                                model=tmodel, device="cpu"))
    want = jax_harness.evaluate_model(params, examples, num_output_frames=T,
                                      depth_scalings=("median",), track_bucket=8, batch_size=4,
                                      model=jmodel)
    got = harness.evaluate_model(params, examples, num_output_frames=T, depth_scalings=("median",),
                                 track_bucket=8, batch_size=4, model=tmodel, device="cpu")
    _assert_metrics_close(got, want)
    # Batched (groups of 4, 1 and 2) equals per video as JAX holds it
    # (tests/integration/test_eval_harness.py): the bottleneck's fixed dither
    # is drawn for the whole [B 128 96] latents, so a video's latents move by
    # up to 1/128 with the batch size, and a few occlusion flags flip.
    _assert_metrics_close(got, harness.aggregate_metrics(per_video, ("median",)),
                          atol=BATCHED_ATOL)


def test_default_model_matches_jax(models, monkeypatch):
    """With no ``model``, both harnesses build ``TrackAutoEncoder3D`` with its
    defaults (f32, plain attention) and load ``params`` into it. The default
    widths are swapped for the tiny ones on both sides, through each
    harness's own constructor call, so the path runs at test size."""
    jmodel, params, tmodel = models
    built = {"jax": [], "port": []}

    def jax_build(**kw):
        built["jax"].append(kw)
        return jax_tiny_model_3d(**kw)

    def port_build(**kw):
        built["port"].append(kw)
        return tiny_model_3d(**kw)

    monkeypatch.setattr(jax_harness, "TrackAutoEncoder3D", jax_build)
    monkeypatch.setattr(harness, "TrackAutoEncoder3D", port_build)
    examples = [_gt_example(seed=i) for i in range(3)]
    _assert_no_pair_near_a_threshold(tmodel, examples)
    cfg = dict(num_output_frames=T, use_dino=False, use_depth=False, track_bucket=8)
    want = jax_harness.evaluate_model(params, examples, batch_size=4, **cfg)
    got = harness.evaluate_model(params, examples, batch_size=4, device="cpu", **cfg)
    _assert_metrics_close(got, want)
    _assert_metrics_close(harness.evaluate_video(params, examples[0], device="cpu", **cfg),
                          jax_harness.evaluate_video(params, examples[0], **cfg))
    assert [{k: v for k, v in kw.items() if k != "device"} for kw in built["port"]] == \
        built["jax"][:1] * len(built["port"])
    assert harness.default_model(T, False, False, "cpu").dtype == torch.float32
    # Each call builds its own model: a caller's params stay out of the next.
    seeded = harness.evaluate_video(None, examples[0], device="cpu", **cfg)
    assert seeded != harness.evaluate_video(params, examples[0], device="cpu", **cfg)
    assert seeded == harness.evaluate_video(None, examples[0], device="cpu", **cfg)


def test_harness_refuses_missing_intrinsics_and_falls_back_to_zeros(models):
    _, _, tmodel = models
    ex = _gt_example()
    del ex["intrinsics"]
    for fn in (harness.evaluate_video, lambda p, e, **kw: harness.evaluate_model(p, [e], **kw)):
        with pytest.raises(ValueError, match="fabricate"):
            fn(None, ex, num_output_frames=T, track_bucket=8, model=tmodel, device="cpu")
    batch, _ = harness.build_eval_batch(ex, num_output_frames=T, track_bucket=8)
    with pytest.raises(ValueError, match="intrinsics"):
        harness.evaluate_batch(None, batch, num_output_frames=T, model=tmodel, device="cpu")
    unusable = {**_gt_example(), "intrinsics": np.zeros(1, np.float32)}  # metrics raise
    got = harness.evaluate_video(None, unusable, num_output_frames=T, track_bucket=8,
                                 model=tmodel, device="cpu")
    assert got == {s: tapvid3d_metrics.zero_metrics() for s in ("median", "per_trajectory")}


def _write_tapvid3d_source(directory, rng, n=6, t=10, count=2):
    directory.mkdir(parents=True)
    for i in range(count):
        np.savez(
            directory / f"video_{i}.npz",
            tracks_XYZ=rng.normal(size=(n, t, 3)).astype(np.float32) + [0, 0, 5],
            visibility=(rng.uniform(size=(n, t)) > 0.2).astype(np.float32),
            queries_xyt=np.stack(
                [rng.uniform(0, 64, n), rng.uniform(0, 64, n),
                 rng.integers(0, t, n).astype(float)], axis=1,
            ).astype(np.float32),
            fx_fy_cx_cy=np.array([100.0, 100.0, 32.0, 32.0], np.float32),
        )


def test_npz_directory_provider_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    _write_tapvid3d_source(tmp_path / "tapvid3d", rng)
    train = tmp_path / "train" / "split_a"
    train.mkdir(parents=True)
    np.savez(train / "a.npz", tracks=rng.normal(size=(5, 4, 2)).astype(np.float32),
             visible=np.ones((5, 4), np.float32),
             dino_features=rng.normal(size=(5, 4, 8)).astype(np.float32))
    np.savez(train / "b.npz", tracks_3d=rng.normal(size=(5, 4, 3)),
             visible=np.ones((5, 4, 1)), depth_features=np.zeros((5, 4, 2)))
    for directory, split in ((tmp_path / "tapvid3d", None), (tmp_path / "train", "split_a")):
        want, got = JaxNpzProvider(str(directory), split), NpzDirectoryProvider(str(directory), split)
        assert got.files == want.files and len(got) == len(want)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for key in b:
                if key == "path":
                    assert a[key] == b[key]
                else:
                    assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                    np.testing.assert_array_equal(a[key], b[key], key)
    with pytest.raises(FileNotFoundError):
        NpzDirectoryProvider(str(tmp_path / "train"))


def test_evaluate_cli_matches_jax(models, tmp_path):
    jmodel, _, _ = models
    rng = np.random.default_rng(0)
    source = tmp_path / "data" / "mysource"
    _write_tapvid3d_source(source, rng, t=T)
    ex = JaxNpzProvider(str(source))[0]
    batch, _ = jax_harness.build_eval_batch(ex, num_output_frames=T, track_bucket=8)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5), batch)["params"]
    ckpt = tmp_path / "tiny_ckpt.npz"
    save_checkpoint_npz(str(ckpt), params)
    port_model = tiny_model_3d(T, use_dino=False, use_depth=False, device="cpu")
    port_model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    _assert_no_pair_near_a_threshold(port_model, JaxNpzProvider(str(source)))
    flags = [f"--checkpoint_path={ckpt}", f"--dataset_path={tmp_path}/data",
             f"--output_dir={tmp_path}/out", "--data_sources=mysource",
             f"--num_output_frames={T}", "--track_bucket=8", "--nouse_dino", "--nouse_depth",
             "--tiny_model", "--depth_scalings=median,per_trajectory"]
    returned = evaluate_cli.main(flags + ["--device=cpu"])
    loaded = json.loads((tmp_path / "out" / "results.json").read_text())
    assert loaded == json.loads(json.dumps(returned))
    assert loaded["split"] == {"mysource": "all_files"}
    want = jax_harness.evaluate_model(params, JaxNpzProvider(str(source)), num_output_frames=T,
                                      depth_scalings=("median", "per_trajectory"),
                                      track_bucket=8, model=jmodel)
    _assert_metrics_close(loaded["per_source"]["mysource"], want)
    for scaling, metrics in want.items():
        for key, value in metrics.items():
            if not key.endswith("_std"):
                assert loaded["overall"][scaling][key] == pytest.approx(value, abs=HARNESS_ATOL)
                assert loaded["overall"][scaling][f"{key}_std"] == 0.0
    # Under --debug_nans a run without NaNs raises nothing and gives the same results.
    assert evaluate_cli.main(flags + ["--device=cpu", "--debug_nans"]) == returned
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_cli.main(flags)  # --device defaults to cuda
