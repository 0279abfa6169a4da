"""Video realism scoring from track-reconstruction error (port of
``tdspa/eval/realism.py``).

``score_tracks`` runs encode -> decode on a set of tracks and returns
per-(frame, track) reconstruction scores plus video-level aggregates, in the
JAX package's keys, dtypes and layouts. ``save_visualization_npz`` writes
the npz contract the visualizer CLI reads (coords, coords_score, video,
intrinsics, extrinsics, visibs).
"""

from __future__ import annotations

import numpy as np
import torch

from tdspa_torch.infer.convert import load_params


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def _reconstruction(model, batch):
    """(error [B Q T], visibility logits [B Q T], target visibility [B Q T])."""
    device = _model_device(model)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    predictions = model(batch)
    err = torch.linalg.vector_norm(predictions.tracks - batch["query_tracks"], dim=-1)
    return err, predictions.visible_logits[..., 0], batch["query_tracks_visible"][..., 0]


def score_tracks(model, params, batch, error_scale: float = 10.0) -> dict:
    """Per-point realism scores from reconstruction error.

    Args:
      model: a ``TrackAutoEncoder3D``; it runs on its own device (numpy
        inputs are moved there).
      params: flax tree or ``state_dict`` to load first, or None for the
        model's own weights.
      batch: model batch including query_tracks/query_tracks_visible targets.
      error_scale: error -> score mapping scale; score = exp(-scale * err).

    Returns:
      dict with
        'coords_score': [T Q] in [0, 1] (1 = perfectly reconstructed),
        'point_error': [Q T] raw reconstruction distance,
        'visible_agreement': fraction where predicted visibility matches,
        'realism_score': scalar visibility-weighted mean score,
        'mean_error': scalar visibility-weighted mean distance.
    """
    load_params(model, params)
    err, vis_logits, visible = _reconstruction(model, batch)
    err = err[0].float().cpu().numpy()  # [Q T]
    visible = visible[0].float().cpu().numpy()  # [Q T]
    vis_pred = vis_logits[0].cpu().numpy() > 0

    score = np.exp(-error_scale * err)  # [Q T] in (0, 1]
    weight = np.maximum(visible.sum(), 1.0)
    agree = float(((vis_pred == (visible > 0.5)).sum()) / visible.size)
    return {
        "coords_score": score.T.astype(np.float32),  # [T Q] (visualizer layout)
        "point_error": err.astype(np.float32),
        "visible_agreement": agree,
        "realism_score": float((score * visible).sum() / weight),
        "mean_error": float((err * visible).sum() / weight),
    }


def save_visualization_npz(
    path: str,
    coords,  # [T N 3]
    coords_score,  # [T N]
    video,  # [T H W 3] uint8 RGB
    intrinsics=None,  # [3 3] or [T 3 3]
    extrinsics=None,  # [4 4] or [T 4 4]
    visibs=None,  # [T N]
) -> None:
    """Write the visualizer-CLI input contract (tensors are copied to the host)."""

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    video = host(video)
    video_tchw = np.transpose(video.astype(np.float32) / 255.0, (0, 3, 1, 2))
    if intrinsics is None:
        h, w = video.shape[1:3]
        f = float(max(h, w))
        intrinsics = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    if extrinsics is None:
        extrinsics = np.eye(4, dtype=np.float32)
    out = {
        "coords": host(coords).astype(np.float32),
        "coords_score": host(coords_score).astype(np.float32),
        "video": video_tchw.astype(np.float32),
        "intrinsics": host(intrinsics).astype(np.float32),
        "extrinsics": host(extrinsics).astype(np.float32),
    }
    if visibs is not None:
        out["visibs"] = host(visibs).astype(np.float32)
    np.savez(path, **out)
