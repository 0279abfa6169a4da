"""tdspa_torch.viz, the visualizer's projections (``ops/geometry.py``) and the
visualize CLI against the JAX package on the same numpy-seeded inputs.

Tolerances: the painting helpers and the CLI's frames bit-equal (the same
numpy and OpenCV calls on the same arrays); the projections within 1e-5 px
relative to JAX's f32 (the port sums each product in order as separate ops,
XLA's dot in its own order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.ops import geometry as jgeo
from tdspa.viz import paint as jpaint
from tdspa_torch.ops import geometry
from tdspa_torch.viz import paint

PROJ_TOL = dict(rtol=1e-5, atol=1e-5)


def _tracks_and_scores(seed=0, t=6, n=7, h=24, w=32):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8)
    # Some points leave the frame (skipped), some trail segments cross it.
    tracks = np.stack([rng.uniform(-4, w + 4, (n, t)), rng.uniform(-4, h + 4, (n, t))], -1)
    return video, tracks.astype(np.float32), rng.uniform(size=(t, n)).astype(np.float32)


def test_colormap_and_normalisation_are_bit_equal():
    scores = np.random.default_rng(1).uniform(-0.2, 1.2, (5, 9)).astype(np.float32)
    np.testing.assert_array_equal(paint.scores_to_colors_bgr(scores),
                                  jpaint.scores_to_colors_bgr(scores))
    for s in (0.0, 0.25, 0.5, 0.75, 1.0, 1.5):
        assert paint.score_to_color_bgr(s) == jpaint.score_to_color_bgr(s)
    for normalize in (True, False):
        np.testing.assert_array_equal(paint.normalize_scores(scores, normalize),
                                      jpaint.normalize_scores(scores, normalize))
    flat = np.full((2, 3), 0.4, np.float32)  # hi == lo
    np.testing.assert_array_equal(paint.normalize_scores(flat), jpaint.normalize_scores(flat))


@pytest.mark.parametrize("trail,point_size", [(5, 2), (0, 1), (2, 3)])
def test_painting_is_bit_equal(trail, point_size):
    pytest.importorskip("cv2")
    video, tracks, scores = _tracks_and_scores()
    got = paint.paint_point_track_with_colors(video, tracks, None, scores, trail, point_size)
    want = jpaint.paint_point_track_with_colors(video, tracks, None, scores, trail, point_size)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, video)  # something was drawn
    float_video = np.random.default_rng(2).uniform(size=(3, 3, 8, 8)).astype(np.float32)
    for a, b in zip(paint.prepare_video_for_visualization(float_video),
                    jpaint.prepare_video_for_visualization(float_video)):
        np.testing.assert_array_equal(a, b)


def test_project_3d_to_2d_matches_jax():
    """tests/unit/test_geometry.py:126's case, plus points behind the camera
    and on its plane (the divide's 1e-8 and the NaN/inf -> 0 rule)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(6, 3)).astype(np.float32) + [0, 0, 4.0]
    pts = np.concatenate([pts, [[0.5, 0.5, -2.0], [0.0, 0.0, -0.5], [np.inf, 0.0, 1.0]]])
    pts = pts.astype(np.float32)
    intr = np.array([[100.0, 0, 32], [0, 110.0, 24], [0, 0, 1]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.1, -0.2, 0.5]
    got_xy, got_z = geometry.project_3d_to_2d(torch.from_numpy(pts), intr, extr)
    want_xy, want_z = jgeo.project_3d_to_2d(jnp.asarray(pts), jnp.asarray(intr),
                                            jnp.asarray(extr))
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy), **PROJ_TOL)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **PROJ_TOL)
    assert got_xy.dtype == torch.float32 and np.isfinite(got_xy.numpy()).all()


@pytest.mark.parametrize("per_frame", [False, True])
def test_project_all_tracks_matches_jax(per_frame):
    """tests/unit/test_geometry.py:143's case (resize 64 of 32, clipping to
    the original bounds), with per-frame cameras as the npz may carry."""
    rng = np.random.default_rng(1)
    t, n = 3, 5
    coords = (rng.normal(size=(t, n, 3)) + [0, 0, 5.0]).astype(np.float32)
    intr = np.array([[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    if per_frame:
        intr = np.stack([intr * [[1 + 0.1 * i], [1], [1]] for i in range(t)]).astype(np.float32)
        extr = np.tile(extr, (t, 1, 1))
        extr[:, 0, 3] = [0.0, 0.3, -0.3]
    kw = dict(resize_height=64, resize_width=64, original_height=32, original_width=32)
    got = geometry.project_all_tracks(torch.from_numpy(coords), intr, extr, **kw)
    want = np.asarray(jgeo.project_all_tracks(jnp.asarray(coords), jnp.asarray(intr),
                                              jnp.asarray(extr), **kw))
    assert tuple(got.shape) == want.shape == (n, t, 2)
    np.testing.assert_allclose(got.numpy(), want, **PROJ_TOL)
    assert (got >= 0).all() and (got <= 31).all()
    # The default original size (512) and resize (1024).
    np.testing.assert_allclose(
        geometry.project_all_tracks(torch.from_numpy(coords), intr, extr).numpy(),
        np.asarray(jgeo.project_all_tracks(jnp.asarray(coords), jnp.asarray(intr),
                                           jnp.asarray(extr))), **PROJ_TOL)


def test_visualize_cli_matches_jax(tmp_path):
    """tests/integration/test_cli.py:153's inputs through both CLIs: the same
    frames, the same mp4 frame count and size."""
    cv2 = pytest.importorskip("cv2")
    from tdspa.cli import visualize as jax_cli
    from tdspa_torch.cli import visualize as port_cli

    rng = np.random.default_rng(0)
    t, n, h, w = 4, 5, 32, 32
    np.savez(
        tmp_path / "viz.npz",
        coords=rng.normal(size=(t, n, 3)).astype(np.float32) + [0, 0, 5],
        coords_score=rng.uniform(size=(t, n)).astype(np.float32),
        video=rng.uniform(size=(t, 3, h, w)).astype(np.float32),
        intrinsics=np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32),
        extrinsics=np.eye(4, dtype=np.float32),
    )
    jax_cli.main([f"--npz_path={tmp_path}/viz.npz", "--save_frames",
                  f"--output_dir={tmp_path}/jax"])
    out = port_cli.main([f"--npz_path={tmp_path}/viz.npz", "--save_frames",
                         f"--output_dir={tmp_path}/port", "--device=cpu"])
    assert out == tmp_path / "port" / "viz_visualized.mp4" and out.exists()
    for i in range(t):
        name = f"viz_visualized/frame_{i:05d}.png"
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / name)),
                                      cv2.imread(str(tmp_path / "jax" / name)), err_msg=name)
    cap = cv2.VideoCapture(str(out))
    frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    assert (frames, size) == (t, (w, h))
    # Raw scores (--no_normalize_scores, JAX's spelling, and --nonormalize_scores).
    for flag in ("--no_normalize_scores", "--nonormalize_scores"):
        assert not port_cli.build_parser().parse_args(
            ["--npz_path=x.npz", flag]).normalize_scores
    assert Path(port_cli.build_parser().parse_args(["--npz_path=x.npz"]).npz_path).name == "x.npz"
