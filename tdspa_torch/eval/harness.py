"""TAPVid-3D evaluation harness (port of ``tdspa/eval/harness.py``).

As in the JAX package:

* the model forward runs on the device; metric math runs on the host over
  numpy;
* model query points are (t, x, y, z) from the ground-truth 3D track at the
  query frame;
* every video is padded to shape buckets (tracks to a multiple of
  ``track_bucket``, frames to the model's T); videos of one bucket stack
  into forwards of up to ``batch_size``, and padded queries are dropped
  before metrics;
* support tracks are the query tracks themselves (TAPVid-3D ground truth
  has no separate support set).

Where JAX compiles one forward per model configuration, the port builds one
model per call and reuses it for every forward of that call. The default model
is JAX's: ``TrackAutoEncoder3D`` with its defaults (f32, plain attention), so
the metrics match the reference's on the same checkpoint; pass ``model=`` for
other numerics, e.g. the pipeline's bf16 model with the fused attention kernel
(``tdspa_torch/csrc/attention.cu``). ``params`` is a flax tree, a
``state_dict``, or None for the model's own (seeded) weights; given with a
``model``, they are loaded into that model. Every entry takes ``device``
("cuda" unless the caller asks for the CPU); a model passed in must live there.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tdspa_torch.eval.tapvid3d_metrics import compute_tapvid3d_metrics, zero_metrics
from tdspa_torch.infer.convert import load_params
from tdspa_torch.models import TrackAutoEncoder3D
from tdspa_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def convert_predictions_to_tapvid3d_format(predictions, query_points=None):
    """[B Q T 3] predictions -> ([T N 3] tracks, [T N] occluded) numpy.

    Occluded = visibility logit <= 0.
    """
    del query_points
    pred_tracks = np.transpose(_numpy(predictions.tracks)[0], (1, 0, 2))  # [T Q 3]
    pred_occluded = _numpy(predictions.visible_logits)[0, :, :, 0] <= 0.0
    return pred_tracks, np.transpose(pred_occluded, (1, 0))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_example_to_bucket(tracks, visible, query_points, num_frames, track_bucket):
    """Pad [N T 3]/[N T 1]/[Q 4] to static bucket shapes.

    Frames pad to ``num_frames`` (masked past ``boundary_frame``); tracks and
    queries pad to the next multiple of ``track_bucket`` (padded tracks are
    marked invisible so they are masked out of encoder attention; padded
    queries are sliced off the predictions).
    """
    n, t = tracks.shape[:2]
    q = query_points.shape[0]
    n_pad = _round_up(max(n, 1), track_bucket)
    q_pad = _round_up(max(q, 1), track_bucket)
    t_pad = num_frames

    tracks_p = np.zeros((n_pad, t_pad, tracks.shape[-1]), np.float32)
    tracks_p[:n, : min(t, t_pad)] = tracks[:, :t_pad]
    visible_p = np.zeros((n_pad, t_pad, 1), np.float32)
    visible_p[:n, : min(t, t_pad)] = visible[:, :t_pad]
    queries_p = np.zeros((q_pad, query_points.shape[-1]), np.float32)
    queries_p[:q] = query_points
    return tracks_p, visible_p, queries_p, min(t, t_pad)


def default_model(num_output_frames: int, use_dino: bool, use_depth: bool,
                  device) -> TrackAutoEncoder3D:
    """JAX's harness model of a configuration (``TrackAutoEncoder3D`` with
    its defaults: f32, plain attention), with seeded random weights until
    ``params`` are loaded into it."""
    return TrackAutoEncoder3D(num_output_frames=num_output_frames, use_dino=use_dino,
                              use_depth=use_depth, device=device)


def _model(params, num_output_frames, use_dino, use_depth, model, device):
    """The model to run, on ``device``, with ``params`` loaded."""
    device = resolve_device(device)
    if model is None:
        model = default_model(num_output_frames, use_dino, use_depth, device)
    else:
        where = next(model.parameters()).device
        if where.type != device.type:
            raise ValueError(f"model lives on {where}, but device={str(device)!r} was asked for")
    load_params(model, params)
    return model


@torch.inference_mode()
def _forward(model, batch):
    device = next(model.parameters()).device
    return model({k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()})


def evaluate_batch(
    params,
    batch,
    num_output_frames: int = 150,
    use_dino: bool = True,
    use_depth: bool = True,
    scaling: str = "per_trajectory",
    model=None,
    device="cuda",
):
    """Forward on the device + metrics on the host for one prepared batch.

    Returns (metrics dict, predictions).
    """
    model = _model(params, num_output_frames, use_dino, use_depth, model, device)
    if "intrinsics" not in batch:
        raise ValueError(
            "evaluate_batch: batch has no 'intrinsics' (fx, fy, cx, cy). "
            "TAPVid-3D metrics project 3D tracks through the camera; "
            "fabricating intrinsics silently corrupts every pixel-threshold "
            "metric, so they are required."
        )
    predictions = _forward(model, batch)

    query_points = _numpy(batch["query_points"][0])
    pred_tracks, pred_occluded = convert_predictions_to_tapvid3d_format(predictions)
    gt_tracks = np.transpose(_numpy(batch["query_tracks"][0]), (1, 0, 2))
    gt_occluded = np.transpose(
        np.logical_not(_numpy(batch["query_tracks_visible"][0, :, :, 0])), (1, 0)
    )
    metrics = compute_tapvid3d_metrics(
        gt_occluded=gt_occluded,
        gt_tracks=gt_tracks,
        pred_occluded=pred_occluded,
        pred_tracks=pred_tracks,
        intrinsics_params=_numpy(batch["intrinsics"][0]),
        scaling=scaling,
        query_points=query_points[:, ::-1],  # reference layout: (t, y, x)
        order="t n",
    )
    return {k: float(v) for k, v in metrics.items()}, predictions


def _intrinsics(example):
    if "intrinsics" in example:
        return example["intrinsics"]
    return example.get("fx_fy_cx_cy")


def build_eval_batch(example, num_output_frames: int = 150, track_bucket: int = 256):
    """Model batch (host tensors) from a TAPVid-3D ground-truth example.

    ``queries_xyt`` carries (x, y, t) pixel-space queries; the model contract
    is (t, x, y, z) in 3D camera space, so query points are rebuilt from the
    ground-truth 3D track at the query frame. Support := query tracks.
    """
    tracks = np.asarray(example["tracks_3d"], np.float32)  # [N T 3]
    visible = np.asarray(example["visible"], np.float32)
    if visible.ndim == 2:
        visible = visible[..., None]
    queries_xyt = np.asarray(example["queries_xyt"], np.float32)  # [N 3] (x,y,t)

    n, t = tracks.shape[:2]
    qf = np.clip(np.round(queries_xyt[:, 2]).astype(int), 0, t - 1)
    coords = tracks[np.arange(n), qf]  # [N 3]
    query_points = np.concatenate(
        [qf[:, None].astype(np.float32), coords], axis=1
    )  # [N 4] (t, x, y, z)

    tracks_p, visible_p, queries_p, t_used = pad_example_to_bucket(
        tracks, visible, query_points, num_output_frames, track_bucket
    )
    batch = {
        "support_tracks": torch.from_numpy(tracks_p[np.newaxis]),
        "support_tracks_visible": torch.from_numpy(visible_p[np.newaxis]),
        "query_points": torch.from_numpy(queries_p[np.newaxis]),
        "query_tracks": torch.from_numpy(tracks_p[np.newaxis].copy()),
        "query_tracks_visible": torch.from_numpy(visible_p[np.newaxis].copy()),
        "boundary_frame": torch.tensor([t_used], dtype=torch.int32),
    }
    intr = _intrinsics(example)
    if intr is not None:
        batch["intrinsics"] = torch.from_numpy(np.asarray(intr, np.float32)[np.newaxis])
    meta = {"num_tracks": n, "num_frames": t_used, "queries_xyt": queries_xyt}
    return batch, meta


def _require_intrinsics(example, caller: str) -> None:
    if _intrinsics(example) is None:
        raise ValueError(
            f"{caller}: example has no intrinsics ('intrinsics' or 'fx_fy_cx_cy'). "
            "TAPVid-3D npz files carry fx_fy_cx_cy; refusing to fabricate "
            "camera parameters."
        )


def _video_metrics(example, pred_tracks, pred_occluded, n, t, queries_xyt, depth_scalings):
    """Host-side metrics for one video's (sliced) predictions, with the
    zero-metrics fallback per scaling."""
    gt_tracks = np.transpose(np.asarray(example["tracks_3d"])[:, :t], (1, 0, 2))
    vis = np.asarray(example["visible"])
    if vis.ndim == 3:
        vis = vis[..., 0]
    gt_occluded = np.transpose(~vis[:, :t].astype(bool), (1, 0))
    intrinsics = np.asarray(_intrinsics(example))
    video_metrics = {}
    for scaling in depth_scalings:
        try:
            m = compute_tapvid3d_metrics(
                gt_occluded=gt_occluded,
                gt_tracks=gt_tracks,
                pred_occluded=pred_occluded,
                pred_tracks=pred_tracks,
                intrinsics_params=intrinsics,
                scaling=scaling,
                query_points=queries_xyt[:, ::-1],
                order="t n",
            )
            video_metrics[scaling] = {k: float(v) for k, v in m.items()}
        except Exception as e:  # noqa: BLE001 - the reference's zero-fallback
            logger.warning("Metrics failed (scaling=%s): %s", scaling, e)
            video_metrics[scaling] = zero_metrics()
    return video_metrics


def evaluate_video(
    params,
    example,
    num_output_frames: int = 150,
    use_dino: bool = True,
    use_depth: bool = True,
    depth_scalings=("median", "per_trajectory"),
    track_bucket: int = 256,
    model=None,
    device="cuda",
):
    """Per-video metrics dict {scaling: metrics} with zero-fallback."""
    _require_intrinsics(example, "evaluate_video")
    model = _model(params, num_output_frames, use_dino, use_depth, model, device)
    batch, meta = build_eval_batch(example, num_output_frames, track_bucket)
    predictions = _forward(model, batch)
    n, t = meta["num_tracks"], meta["num_frames"]
    pred_tracks, pred_occluded = convert_predictions_to_tapvid3d_format(predictions)
    return _video_metrics(example, pred_tracks[:t, :n], pred_occluded[:t, :n], n, t,
                          meta["queries_xyt"], depth_scalings)


def aggregate_metrics(per_video: list[dict], depth_scalings) -> dict:
    """mean/std aggregation over videos."""
    out: dict = {}
    for scaling in depth_scalings:
        out[scaling] = {}
        if not per_video:
            continue
        for key in per_video[0][scaling]:
            values = [v[scaling][key] for v in per_video]
            out[scaling][key] = float(np.mean(values))
            out[scaling][f"{key}_std"] = float(np.std(values))
    return out


def evaluate_model(
    params,
    dataset,
    num_output_frames: int = 150,
    use_dino: bool = True,
    use_depth: bool = True,
    depth_scalings=("median", "per_trajectory"),
    track_bucket: int = 256,
    batch_size: int = 8,
    model=None,
    device="cuda",
) -> dict:
    """Evaluate over an iterable of ground-truth examples; returns
    {scaling: aggregated metrics}.

    Videos whose bucket-padded shapes match stack into ``batch_size``-sized
    forwards; partial groups pad by repeating the last video up to the next
    power of two (never beyond ``batch_size``), so each bucket sees at most
    log2(batch_size) + 1 batch shapes. Metrics stay per video on the host.
    """
    model = _model(params, num_output_frames, use_dino, use_depth, model, device)
    per_video: list[dict] = []

    def flush(items):
        if not items:
            return
        real = len(items)
        target = 1
        while target < real:
            target *= 2
        target = min(target, batch_size)
        while len(items) < target:
            items.append(items[-1])  # results dropped
        stacked = {k: torch.cat([b[k] for (b, _, _) in items], dim=0) for k in items[0][0]}
        predictions = _forward(model, stacked)
        all_tracks = _numpy(predictions.tracks)  # [B Q T 3]
        all_occ = _numpy(predictions.visible_logits)[..., 0] <= 0.0
        for i, (_, meta, example) in enumerate(items[:real]):
            n, t = meta["num_tracks"], meta["num_frames"]
            pred_tracks = np.transpose(all_tracks[i], (1, 0, 2))[:t, :n]
            pred_occluded = np.transpose(all_occ[i], (1, 0))[:t, :n]
            per_video.append(
                _video_metrics(example, pred_tracks, pred_occluded, n, t,
                               meta["queries_xyt"], depth_scalings)
            )

    groups: dict = {}
    for example in dataset:
        _require_intrinsics(example, "evaluate_model")
        batch, meta = build_eval_batch(example, num_output_frames, track_bucket)
        key = tuple((k, tuple(batch[k].shape)) for k in sorted(batch))
        groups.setdefault(key, []).append((batch, meta, example))
        if len(groups[key]) == batch_size:
            flush(groups.pop(key))
    for items in groups.values():
        flush(items)
    return aggregate_metrics(per_video, depth_scalings)
