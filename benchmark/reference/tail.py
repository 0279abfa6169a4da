"""Plain reference of the serving tail: lift the 2D tracks to 3D with the
depth maps, sample the DINO grid and the depth features at the tracks, split
support and query tracks, and run the 3D autoencoder.

Bilinear sampling takes its weights from the unclamped floor and clamps each
corner to the grid on its own (points outside take edge values with
out-of-range weights). The camera of the lift is fx = fy = max(H, W),
cx = W / 2, cy = H / 2. The depth features of a point are (d, d / 10,
d_t - d_{t-1}, then zeros to 256 channels).
"""

from __future__ import annotations

import torch

from benchmark.reference.model import Model


def bilinear(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [T H W C] at coords [N T 2] (x, y) -> [N T C], f32."""
    height, width = grid.shape[1], grid.shape[2]
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0f)[..., None], (y - y0f)[..., None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, width - 1), (xi + 1).clamp(0, width - 1)
    y0, y1 = yi.clamp(0, height - 1), (yi + 1).clamp(0, height - 1)
    t = torch.arange(grid.shape[0], device=grid.device)[None, :]
    g = grid.float()
    return (g[t, y0, x0] * (1 - wx) * (1 - wy) + g[t, y0, x1] * wx * (1 - wy)
            + g[t, y1, x0] * (1 - wx) * wy + g[t, y1, x1] * wx * wy)


def lift(tracks_2d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    height, width = depth.shape[1], depth.shape[2]
    f = float(max(height, width))
    z = bilinear(depth, tracks_2d)[..., 0]
    x, y = tracks_2d[..., 0], tracks_2d[..., 1]
    return torch.stack([(x - width / 2.0) * z / f, (y - height / 2.0) * z / f, z], dim=-1)


def depth_features(depth: torch.Tensor, tracks_2d: torch.Tensor, dim: int = 256) -> torch.Tensor:
    d = bilinear(depth, tracks_2d)[..., 0]
    grad = torch.cat([torch.zeros_like(d[..., :1]), d[..., 1:] - d[..., :-1]], dim=-1)
    zeros = torch.zeros(d.shape + (dim - 3,), device=d.device)
    return torch.cat([d[..., None], (d / 10.0)[..., None], grad[..., None], zeros], dim=-1)


def split(perm, ts, tracks, visible, num_support, num_queries, frames, dino=None, depth=None):
    """A batch of one: support tracks perm[:S], query tracks the next Q, each
    query at its frame ts (clipped to the track), laid out (t, coords)."""
    support, query = perm[:num_support], perm[num_support:num_support + num_queries]
    qt = tracks[query]
    at = qt[torch.arange(num_queries, device=tracks.device), ts.clamp(max=tracks.shape[1] - 1)]
    batch = {
        "support_tracks": tracks[support][None],
        "support_tracks_visible": visible[support][None],
        "query_points": torch.cat([ts[:, None].float(), at], dim=1)[None],
        "query_tracks": qt[None],
        "query_tracks_visible": visible[query][None],
        "boundary_frame": torch.full((1,), frames, device=tracks.device),
    }
    if dino is not None:
        batch["dino_features"] = dino[support][None]
    if depth is not None:
        batch["depth_features"] = depth[support][None]
    return batch


def tail(model: Model, tracks_2d, visible, dino_grid, depth_maps, perm, ts, num_support: int,
         num_queries: int, video_hw: tuple[int, int]) -> dict:
    """Predictions of one request: {"tracks" [1 Q T 3], "visible_logits" [1 Q T 1]}."""
    frames = tracks_2d.shape[1]
    height, width = video_hw
    tracks_3d = lift(tracks_2d, depth_maps)
    scale = torch.tensor([dino_grid.shape[2] / width, dino_grid.shape[1] / height],
                         device=tracks_2d.device)
    dino = bilinear(dino_grid, tracks_2d * scale)
    depth = depth_features(depth_maps, tracks_2d)
    batch = split(perm, ts, tracks_3d, visible, num_support, num_queries, frames, dino, depth)
    return model(batch)
