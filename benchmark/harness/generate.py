"""Traffic made from the seed on the device, by the parameters of a traffic
file. Frozen copies of the generators the repository's GPU smoke test uses:
the seeded front ends of the serving tail (moving tracks on a grid, a DINO
patch grid, positive depth maps) and the synthetic training tracks
(sinusoidal orbits) split into support and query tracks.
"""

from __future__ import annotations

import math

import torch


def front_ends(p: dict, gen: torch.Generator, device) -> dict:
    """Tracks moving on a ``grid`` x ``grid`` lattice of a ``height`` x
    ``width`` frame (drift plus a wobble of 3 px), 90 % visible, a DINO grid
    of standard normals and depth maps uniform in [1, 5)."""
    grid, frames, height, width = p["grid"], p["frames"], p["height"], p["width"]
    step = height / grid
    coords = (torch.arange(grid, device=device, dtype=torch.float32) + 0.5) * step
    gy, gx = torch.meshgrid(coords, coords, indexing="ij")
    start = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    n = start.shape[0]
    t = torch.arange(frames, device=device, dtype=torch.float32)[None, :, None]
    velocity = torch.randn((n, 1, 2), generator=gen, device=device) * 0.5
    wobble = torch.rand((n, 1, 2), generator=gen, device=device) * 2 * math.pi
    tracks = start[:, None, :] + velocity * t + 3.0 * torch.sin(t / 10.0 + wobble)
    return {
        "tracks": tracks.clamp(0, width - 1),
        "visible": (torch.rand((n, frames, 1), generator=gen, device=device) < 0.9).float(),
        "dino": torch.randn((frames, *p["dino_grid"]), generator=gen, device=device),
        "depth": 1.0 + 4.0 * torch.rand((frames, height, width, 1), generator=gen, device=device),
    }


def splits(count: int, num_tracks: int, num_queries: int, frames: int,
           gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``count`` support/query splits: a permutation of the tracks and a
    frame for each query."""
    perms = torch.argsort(torch.rand((count, num_tracks), generator=gen, device=device), dim=1)
    ts = torch.randint(0, frames, (count, num_queries), generator=gen, device=device)
    return perms, ts


def orbit_batch(p: dict, batch: int, coords: int, gen: torch.Generator, device) -> dict:
    """``batch`` examples of ``tracks`` sinusoidal orbits (1-5 turns a clip,
    phase U(0, 2 pi), radius U(0, largest)), split into ``support`` and
    ``queries`` tracks, each query at a random frame. Each example draws, as
    a video would, its own region of the frame (a box whose side per
    coordinate is uniform in ``region_side``, where the orbits' centres
    lie), its own largest radius (uniform in ``largest_radius``) and its own
    share of visible points (uniform in ``visible_share``). The ranges
    ``[1, 1]``, ``[0.1, 0.1]`` and ``[0.8, 0.8]`` give every example the one
    law of the port's ``SyntheticTrackProvider``."""
    n, frames = p["tracks"], p["frames"]
    support, queries = p["support"], p["queries"]

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    side = uniform(*p["region_side"], (batch, 1, 1, coords))
    low = uniform(0.0, 1.0, (batch, 1, 1, coords)) * (1.0 - side)
    largest = uniform(*p["largest_radius"], (batch, 1, 1, 1))
    seen = uniform(*p["visible_share"], (batch, 1, 1, 1))
    shape = (batch, n, 1, coords)
    time = torch.arange(frames, device=device, dtype=torch.float32)[None, None, :, None] / frames
    centre = low + side * uniform(0, 1, shape)
    tracks = centre + largest * uniform(0, 1, shape) * torch.sin(
        2 * math.pi * uniform(1, 5, shape) * time + uniform(0, 2 * math.pi, shape))
    visible = (torch.rand((batch, n, frames, 1), generator=gen, device=device) < seen).float()
    perm = torch.argsort(torch.rand((batch, n), generator=gen, device=device), dim=1)
    sup, qry = perm[:, :support], perm[:, support:support + queries]
    rows = torch.arange(batch, device=device)[:, None]
    query_tracks = tracks[rows, qry]
    ts = torch.randint(0, frames, (batch, queries), generator=gen, device=device)
    at = query_tracks[rows, torch.arange(queries, device=device)[None, :], ts]
    return {
        "support_tracks": tracks[rows, sup],
        "support_tracks_visible": visible[rows, sup],
        "query_points": torch.cat([ts[..., None].float(), at], dim=-1),
        "query_tracks": query_tracks,
        "query_tracks_visible": visible[rows, qry],
        "boundary_frame": torch.full((batch,), frames, device=device, dtype=torch.int32),
    }
