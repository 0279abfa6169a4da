"""Dataset providers (port of ``NpzDirectoryProvider`` from
``tdspa/data/providers.py``; host numpy, as in the JAX package). The other
providers of that module come with the training slice (ROADMAP.md)."""

from __future__ import annotations

import os

import numpy as np


class NpzDirectoryProvider:
    """Examples from a directory of per-video .npz files.

    Training layout keys: ``tracks`` or ``tracks_3d`` [N T C],
    ``visible`` [N T 1] (or [N T]), optional ``dino_features`` /
    ``depth_features``. TAPVid-3D ground-truth layout (``tracks_XYZ``,
    ``visibility``, ``queries_xyt``, ``fx_fy_cx_cy``) is normalized into the
    same example schema plus the eval extras.
    """

    def __init__(self, directory: str, split: str | None = None):
        self.directory = directory
        search_dir = (
            os.path.join(directory, split)
            if split and os.path.isdir(os.path.join(directory, split))
            else directory
        )
        self.files = sorted(
            os.path.join(search_dir, f)
            for f in os.listdir(search_dir)
            if f.endswith(".npz")
        )
        if not self.files:
            raise FileNotFoundError(f"No .npz files under {search_dir}")

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for i in range(len(self.files)):
            yield self[i]

    def __getitem__(self, i: int) -> dict:
        # Unpickles object arrays, as the JAX provider does: trusted files only.
        with np.load(self.files[i], allow_pickle=True) as data:
            example: dict = {"path": self.files[i]}
            if "tracks_XYZ" in data:  # TAPVid-3D ground-truth layout
                vis = np.asarray(data["visibility"], np.float32)
                example.update(
                    tracks_3d=np.asarray(data["tracks_XYZ"], np.float32),  # [N T 3]
                    visible=vis[..., None] if vis.ndim == 2 else vis,
                    queries_xyt=np.asarray(data["queries_xyt"], np.float32),
                    intrinsics=np.asarray(data["fx_fy_cx_cy"], np.float32),
                )
                if "video" in data:
                    example["video"] = np.asarray(data["video"])
                return example
            for key in ("tracks", "tracks_3d"):
                if key in data:
                    example[key] = np.asarray(data[key], np.float32)
            vis = np.asarray(data["visible"], np.float32)
            example["visible"] = vis[..., None] if vis.ndim == 2 else vis
            for key in ("dino_features", "depth_features", "video"):
                if key in data:
                    example[key] = np.asarray(data[key])
        return example
