"""Tracking-quality metrics against ground truth (a copy of
``tdspa/eval/tracking_quality.py``; numpy only).

Scores a track provider's output (``{'tracks': [N T 2], 'visible':
[N T (1)]}``) against ground-truth tracks + visibility, e.g. from
``tdspa_torch.utils.synthetic_video.make_tracking_scene``. CoTracker-style
conventions: position error is reported over ground-truth-visible frames;
occlusion detection is a binary classification of the visibility flags.
"""

from __future__ import annotations

import numpy as np


def tracking_quality(pred, gt_tracks, gt_visible, query_frame: int = 0) -> dict:
    """Position + visibility metrics; query_frame is excluded (it is input).

    Args:
      pred: dict with 'tracks' [N T 2] and 'visible' [N T] or [N T 1].
      gt_tracks: [N T 2] ground truth positions.
      gt_visible: [N T] bool ground truth visibility.
    """
    tracks = np.asarray(pred["tracks"], np.float32)
    vis = np.asarray(pred["visible"])
    if vis.ndim == 3:
        vis = vis[..., 0]
    pred_vis = vis > 0.5
    gt_tracks = np.asarray(gt_tracks, np.float32)
    gt_vis = np.asarray(gt_visible, bool)

    n, t = gt_vis.shape
    evaluate = np.ones((n, t), bool)
    evaluate[:, query_frame] = False

    err = np.linalg.norm(tracks - gt_tracks, axis=-1)  # [N T]
    gv = gt_vis & evaluate
    go = ~gt_vis & evaluate

    def _mean(values, mask):
        return float(values[mask].mean()) if mask.any() else float("nan")

    out = {
        # Position error over gt-visible frames (the tracker must localize
        # everything it should see)...
        "epe_gt_visible": _mean(err, gv),
        # ...and over frames it also claims to see (its trustworthy subset).
        "epe_both_visible": _mean(err, gv & pred_vis),
        "visibility_accuracy": _mean((pred_vis == gt_vis).astype(float), evaluate),
        # Occlusion detection: occluded = positive class.
        "occlusion_recall": _mean((~pred_vis).astype(float), go),
        "visible_recall": _mean(pred_vis.astype(float), gv),
    }
    for d in (1, 2, 4, 8):
        out[f"pts_within_{d}"] = _mean((err < d).astype(float), gv)
    return out
