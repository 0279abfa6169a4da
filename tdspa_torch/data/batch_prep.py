"""Support/query split + query-point sampling (port of
``tdspa/data/batch_prep.py::split_and_sample_queries``).

RNG contract: the JAX function draws its permutation and query frames from
one ``jax.random`` key, a stream PyTorch cannot reproduce. The port takes
both draws as tensors: ``perm`` (a permutation of the N tracks) and ``ts``
(one frame index in [0, num_frames) per query). ``InferencePipeline`` draws
them from ``torch.Generator().manual_seed(seed)`` on the CPU (the same split
on every device for a given seed); parity tests inject the indices JAX drew.
"""

from __future__ import annotations

import torch


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
        "boundary_frame": torch.tensor([num_frames], device=tracks.device),
    }
    if dino_features is not None:
        out["dino_features"] = dino_features[support_idx][None]
    if depth_features is not None:
        out["depth_features"] = depth_features[support_idx][None]
    return out
