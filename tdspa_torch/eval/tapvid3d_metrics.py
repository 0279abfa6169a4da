"""TAPVid-3D metrics: occlusion accuracy, 3D pts-within, 3D Jaccard (a copy of
``tdspa/eval/tapvid3d_metrics.py``; host numpy, as in the JAX package).

The reference delegates to ``tapnet.tapvid3d.evaluation.metrics``
(evaluate_tapvid3d.py:17, 100-109). When tapnet is importable we delegate too
(exact parity); otherwise this module's vendored implementation is used. It
follows the TAPVid-3D benchmark definition (Koppula et al., 2024 — the 3D
extension of the TAPVid Jaccard metrics):

* Predictions may be correct up to scale; ``scaling`` re-scales predicted
  tracks to the ground truth: ``'median'`` (one global scale from the median
  visible-point norm ratio), ``'per_trajectory'`` (one scale per track),
  ``'none'``.
* Distance thresholds are *depth-adaptive*: a threshold of ``d`` pixels at a
  ground-truth point with depth ``z`` and focal length ``f = (fx+fy)/2``
  becomes a 3D ball of radius ``d * z / f`` — equal apparent (projected)
  error across depths.
* ``pts_within_d``: fraction of ground-truth-visible points within the ball.
* ``jaccard_d``: TP/(TP+FP+FN); TP = gt-visible & pred-visible & within;
  FP = pred-visible & (gt-occluded | not-within); FN = gt-visible &
  (pred-occluded | not-within).
* ``occlusion_accuracy``: agreement of the occlusion flags.
* When ``query_points`` is given (t, y, x[, z]) the query frame of each
  track is excluded from evaluation (it is given to the model, not
  predicted).

Metric keys match the reference's fallback dict exactly
(evaluate_tapvid3d.py:216-231).

Parity notes vs tapnet (the JAX package's copy is pinned by hand-computed
vectors in tests/unit/test_metrics.py and the tapnet-semantics transcription
suite in tests/unit/test_tapvid3d_parity.py; tests/test_torch_eval.py holds
this copy equal to it). Transcribed tapnet semantics honored here:
* depth-adaptive threshold multiplier = ``z / sqrt(fx*fy)`` (geometric focal
  mean — tapnet ``get_pointwise_threshold_multiplier``); ``within`` is a
  STRICT ``<`` comparison (tapnet compares squared distances with ``<``).
* tapnet squares the (signed) threshold, so a negative-depth point gets the
  ball of its |z|; we use ``abs(z)`` directly — identical outcome.
Documented divergences (deliberate, all immaterial on real data):
* median/per_trajectory scaling matches medians of 3D norms over
  gt-visible points (same as tapnet); for a track with ZERO visible points,
  tapnet's ``np.median`` of an empty slice yields NaN (NaN-scaled preds then
  fail every ``within`` test, and such tracks contribute to no
  visible-denominator anyway); we use scale=1.0 — metric values identical,
  without propagating NaN.
* ``use_fixed_metric_threshold`` interprets the thresholds as raw meters;
  tapnet's fixed-threshold table is a separate config not exercised by the
  reference (evaluate_tapvid3d.py never sets it). The tapnet branch is not
  handed the option and refuses it.
"""

from __future__ import annotations

import numpy as np

PIXEL_THRESHOLDS = (1, 2, 4, 8, 16)

try:  # exact-parity delegation when the official implementation exists
    from tapnet.tapvid3d.evaluation import metrics as _tapnet_metrics

    TAPNET_AVAILABLE = True
except ImportError:
    _tapnet_metrics = None
    TAPNET_AVAILABLE = False


def zero_metrics() -> dict:
    """The reference's zero-fallback dict (evaluate_tapvid3d.py:216-231)."""
    out = {"occlusion_accuracy": 0.0}
    for d in PIXEL_THRESHOLDS:
        out[f"pts_within_{d}"] = 0.0
        out[f"jaccard_{d}"] = 0.0
    out["average_jaccard"] = 0.0
    out["average_pts_within_thresh"] = 0.0
    return out


def _to_nt(arr, order: str):
    """Normalize 't n'-ordered arrays to 'n t' leading axes."""
    if order == "t n":
        axes = (1, 0) + tuple(range(2, arr.ndim))
        return np.transpose(arr, axes)
    return arr


def _median_scale(gt, pred, visible):
    """median(|gt|)/median(|pred|) over visible points; 1.0 if degenerate."""
    gt_norm = np.linalg.norm(gt, axis=-1)
    pred_norm = np.linalg.norm(pred, axis=-1)
    if visible.sum() == 0:
        return 1.0
    med_gt = np.median(gt_norm[visible])
    med_pred = np.median(pred_norm[visible])
    if med_pred <= 1e-12 or not np.isfinite(med_pred):
        return 1.0
    return med_gt / med_pred


def compute_tapvid3d_metrics(
    gt_occluded,
    gt_tracks,
    pred_occluded,
    pred_tracks,
    intrinsics_params,
    scaling: str = "median",
    query_points=None,
    order: str = "n t",
    use_fixed_metric_threshold: bool = False,
) -> dict:
    """Compute TAPVid-3D metrics for one video.

    Args:
      gt_occluded: bool[T N] ('t n') or [N T] ('n t'); True = occluded.
      gt_tracks: float[... 3] ground-truth 3D tracks, same order.
      pred_occluded / pred_tracks: predictions, same layout.
      intrinsics_params: (fx, fy, cx, cy).
      scaling: 'median' | 'per_trajectory' | 'none'.
      query_points: optional [N >=1] array whose column 0 is the query frame
        (the reference passes (t, y, x) — evaluate_tapvid3d.py:107); that
        frame is excluded from evaluation per track.
      order: axis order of the inputs.
      use_fixed_metric_threshold: use raw thresholds in meters instead of
        depth-adaptive pixel-equivalent balls.
    """
    if TAPNET_AVAILABLE:
        if use_fixed_metric_threshold:
            raise ValueError(
                "use_fixed_metric_threshold is not passed on to tapnet's metrics; "
                "refusing it rather than dropping it"
            )
        return _tapnet_metrics.compute_tapvid3d_metrics(
            gt_occluded=gt_occluded,
            gt_tracks=gt_tracks,
            pred_occluded=pred_occluded,
            pred_tracks=pred_tracks,
            intrinsics_params=intrinsics_params,
            scaling=scaling,
            query_points=query_points,
            order=order,
        )

    gt_occluded = _to_nt(np.asarray(gt_occluded, bool), order)
    gt_tracks = _to_nt(np.asarray(gt_tracks, np.float64), order)
    pred_occluded = _to_nt(np.asarray(pred_occluded, bool), order)
    pred_tracks = _to_nt(np.asarray(pred_tracks, np.float64), order)
    fx, fy = float(intrinsics_params[0]), float(intrinsics_params[1])
    # tapnet get_pointwise_threshold_multiplier: geometric focal mean.
    focal = float(np.sqrt(fx * fy))

    num_tracks, num_frames = gt_occluded.shape
    gt_visible = ~gt_occluded
    pred_visible = ~pred_occluded

    # Rescale predictions to ground truth.
    if scaling == "median":
        pred_tracks = pred_tracks * _median_scale(gt_tracks, pred_tracks, gt_visible)
    elif scaling == "per_trajectory":
        scaled = np.empty_like(pred_tracks)
        for n in range(num_tracks):
            s = _median_scale(gt_tracks[n], pred_tracks[n], gt_visible[n])
            scaled[n] = pred_tracks[n] * s
        pred_tracks = scaled
    elif scaling not in ("none", None):
        raise ValueError(f"Unknown scaling: {scaling!r}")

    # Evaluation mask: all frames except each track's query frame.
    eval_points = np.ones((num_tracks, num_frames), bool)
    if query_points is not None:
        qf = np.round(np.asarray(query_points)[:, 0]).astype(int)
        qf = np.clip(qf, 0, num_frames - 1)
        eval_points[np.arange(num_tracks), qf] = False

    n_eval = eval_points.sum()
    if n_eval == 0:
        return zero_metrics()

    occ_acc = float(
        (pred_occluded == gt_occluded)[eval_points].sum() / n_eval
    )

    dist = np.linalg.norm(pred_tracks - gt_tracks, axis=-1)  # [N T]
    gt_depth = np.abs(gt_tracks[..., 2])

    metrics = {"occlusion_accuracy": occ_acc}
    all_frac_within, all_jaccard = [], []
    for d in PIXEL_THRESHOLDS:
        if use_fixed_metric_threshold:
            thresh = np.full_like(dist, float(d))
        else:
            # d pixels at depth z subtend a 3D radius of d*z/f.
            thresh = d * gt_depth / focal
        within = dist < thresh

        vis_eval = gt_visible & eval_points
        count_vis = vis_eval.sum()
        frac_within = (
            float((within & vis_eval).sum() / count_vis) if count_vis else 0.0
        )

        tp = (within & vis_eval & pred_visible).sum()
        fp_halluc = (pred_visible & ~gt_visible & eval_points).sum()
        fp_misloc = (pred_visible & vis_eval & ~within).sum()
        fn = count_vis - tp  # gt-visible points not counted as TP
        denom = tp + fp_halluc + fp_misloc + fn
        jac = float(tp / denom) if denom else 0.0

        metrics[f"pts_within_{d}"] = frac_within
        metrics[f"jaccard_{d}"] = jac
        all_frac_within.append(frac_within)
        all_jaccard.append(jac)

    metrics["average_jaccard"] = float(np.mean(all_jaccard))
    metrics["average_pts_within_thresh"] = float(np.mean(all_frac_within))
    return metrics
