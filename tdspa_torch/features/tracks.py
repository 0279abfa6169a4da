"""Host 2D point-track providers (port of the host providers of
``tdspa/features/tracks.py``).

A provider maps a ``[T H W 3]`` video to ``{'tracks': [N T 2],
'visible': [N T 1]}``. The LK tracker on the accelerator comes with the
tracking slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


def make_query_grid(height: int, width: int, grid_size: int) -> np.ndarray:
    """[grid_size^2, 2] (x, y) half-pixel-centered grid, row-major over (y, x)."""
    step_x, step_y = width / grid_size, height / grid_size
    j = np.tile(np.arange(grid_size), grid_size)
    i = np.repeat(np.arange(grid_size), grid_size)
    return np.stack([(j + 0.5) * step_x, (i + 0.5) * step_y], axis=1).astype(np.float32)


class StaticGridProvider:
    """Grid points, zero motion, full visibility (smoke-test fallback)."""

    def __init__(self, grid_size: int = 64):
        self.grid_size = grid_size

    def __call__(self, video) -> dict:
        t, h, w = video.shape[:3]
        grid = make_query_grid(h, w, self.grid_size)  # [N 2]
        tracks = np.broadcast_to(grid[:, None, :], (grid.shape[0], t, 2)).copy()
        visible = np.ones((grid.shape[0], t, 1), np.float32)
        return {"tracks": tracks.astype(np.float32), "visible": visible}


class PrecomputedTrackProvider:
    """Tracks from an .npz with 'tracks' [N T 2] and 'visible' [N T (1)]."""

    def __init__(self, npz_path: str):
        self.npz_path = npz_path

    def __call__(self, video) -> dict:
        with np.load(self.npz_path) as data:
            tracks = np.asarray(data["tracks"], np.float32)
            visible = np.asarray(data["visible"], np.float32)
        if visible.ndim == 2:
            visible = visible[..., None]
        return {"tracks": tracks, "visible": visible}
