"""Support/query split + query-point sampling (port of
``tdspa/data/batch_prep.py``).

Two implementations, as in JAX:

* ``prepare_2d_batch`` / ``prepare_3d_batch``: host-side numpy, one example
  -> a batch of one. They draw from ``np.random.default_rng(seed)`` exactly
  as the JAX functions do, so a seed gives JAX's arrays.
* ``split_and_sample_queries``: the device-side split over tensors. The JAX
  function draws its permutation and query frames from one ``jax.random``
  key, a stream PyTorch cannot reproduce, so the port takes both draws as
  tensors: ``perm`` (a permutation of the N tracks) and ``ts`` (one frame
  index in [0, num_frames) per query). ``InferencePipeline`` draws them from
  ``torch.Generator().manual_seed(seed)`` on the CPU (the same split on
  every device for a given seed); parity tests inject the indices JAX drew.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_query_points(query_tracks, num_frames, rng):
    """(t, *coords) of each query track at a uniformly random frame."""
    num_queries, track_frames = query_tracks.shape[:2]
    ts = rng.integers(0, num_frames, size=num_queries)
    ts_clipped = np.minimum(ts, track_frames - 1)
    coords = query_tracks[np.arange(num_queries), ts_clipped]
    return np.concatenate([ts[:, None].astype(coords.dtype), coords], axis=1)


def _prepare_batch(example, tracks_key: str, num_support_tracks: int, num_query_tracks: int,
                   num_frames: int, use_dino: bool = False, use_depth: bool = False,
                   seed: int | None = None) -> dict[str, np.ndarray]:
    tracks = np.asarray(example[tracks_key])
    visible = np.asarray(example["visible"])
    rng = np.random.default_rng(seed)

    indices = rng.permutation(tracks.shape[0])
    support_idx = indices[:num_support_tracks]
    query_idx = indices[num_support_tracks : num_support_tracks + num_query_tracks]
    query_tracks = tracks[query_idx]

    batch = {
        "support_tracks": tracks[support_idx][None],
        "support_tracks_visible": visible[support_idx][None],
        "query_points": _sample_query_points(query_tracks, num_frames, rng)[None],
        "query_tracks": query_tracks[None],
        "query_tracks_visible": visible[query_idx][None],
        "boundary_frame": np.array([num_frames], np.int32),
    }
    if use_dino and "dino_features" in example:
        batch["dino_features"] = np.asarray(example["dino_features"])[support_idx][None]
    if use_depth and "depth_features" in example:
        batch["depth_features"] = np.asarray(example["depth_features"])[support_idx][None]
    return batch


def prepare_2d_batch(example, num_support_tracks: int = 2048, num_query_tracks: int = 2048,
                     num_frames: int = 150, seed: int | None = None) -> dict[str, np.ndarray]:
    """2D TRAJAN batch of one from an example dict with 'tracks' [N T 2]: a
    random permutation gives the first ``num_support_tracks`` tracks to the
    support set and the next ``num_query_tracks`` to the query set."""
    return _prepare_batch(example, "tracks", num_support_tracks, num_query_tracks, num_frames,
                          seed=seed)


def prepare_3d_batch(example, num_support_tracks: int = 2048, num_query_tracks: int = 2048,
                     num_frames: int = 150, use_dino: bool = True, use_depth: bool = True,
                     seed: int | None = None) -> dict[str, np.ndarray]:
    """3DSPA batch of one from an example dict with 'tracks_3d' [N T 3] (and
    the support tracks' DINO / depth features where asked and present)."""
    return _prepare_batch(example, "tracks_3d", num_support_tracks, num_query_tracks,
                          num_frames, use_dino=use_dino, use_depth=use_depth, seed=seed)


def split_and_sample_queries(
    perm: torch.Tensor,  # int[N] permutation of the tracks
    ts: torch.Tensor,  # int[num_queries] query frames
    tracks: torch.Tensor,  # float[N T C]
    visible: torch.Tensor,  # float[N T 1]
    num_support: int,
    num_queries: int,
    num_frames: int,
    dino_features=None,
    depth_features=None,
) -> dict[str, torch.Tensor]:
    """The first ``num_support`` of ``perm`` are support tracks, the next
    ``num_queries`` query tracks; query i is its track at frame ``ts[i]``,
    laid out (t, *coords). Returns a batch of one."""
    support_idx = perm[:num_support]
    query_idx = perm[num_support : num_support + num_queries]
    query_tracks = tracks[query_idx]
    ts_clipped = ts.clamp(max=tracks.shape[1] - 1)
    coords = query_tracks[torch.arange(num_queries, device=tracks.device), ts_clipped]
    query_points = torch.cat([ts[:, None].to(coords.dtype), coords], dim=1)

    out = {
        "support_tracks": tracks[support_idx][None],
        "support_tracks_visible": visible[support_idx][None],
        "query_points": query_points[None],
        "query_tracks": query_tracks[None],
        "query_tracks_visible": visible[query_idx][None],
        "boundary_frame": torch.full((1,), num_frames, device=tracks.device),
    }
    if dino_features is not None:
        out["dino_features"] = dino_features[support_idx][None]
    if depth_features is not None:
        out["depth_features"] = depth_features[support_idx][None]
    return out
