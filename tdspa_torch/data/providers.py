"""Dataset providers (port of ``tdspa/data/providers.py``; host numpy, as
in the JAX package).

* ``SyntheticTrackProvider``: analytic tracks for tests and demo training,
  the same ``default_rng(seed * 100003 + i)`` draws as JAX, so the same
  arrays.
* ``NpzDirectoryProvider``: a directory of ``.npz`` files, one video each.
* ``TfdsTrackProvider``: a ``tensorflow_datasets`` dataset, when tfds is
  installed.
* ``BatchedTrackDataset`` and ``load_{kubric3d,tapvid,tapvid3d}_dataset``:
  prepared batches of numpy arrays for the training loop, which moves them
  to the device (``tdspa_torch.data.prefetch``).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from tdspa_torch.data.batch_prep import prepare_2d_batch, prepare_3d_batch


class SyntheticTrackProvider:
    """Analytic sinusoidal-orbit tracks; deterministic per (seed, index)."""

    def __init__(self, num_videos: int = 16, num_tracks: int = 64, num_frames: int = 24,
                 num_coords: int = 3, with_features: bool = False, seed: int = 0):
        self.num_videos = num_videos
        self.num_tracks = num_tracks
        self.num_frames = num_frames
        self.num_coords = num_coords
        self.with_features = with_features
        self.seed = seed

    def __len__(self):
        return self.num_videos

    def __iter__(self) -> Iterator[dict]:
        for i in range(self.num_videos):
            yield self[i]

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + i)
        n, t, c = self.num_tracks, self.num_frames, self.num_coords
        center = rng.uniform(0, 1, (n, 1, c))
        radius = rng.uniform(0, 0.1, (n, 1, c))
        phase = rng.uniform(0, 2 * np.pi, (n, 1, c))
        freq = rng.uniform(1, 5, (n, 1, c))
        time = np.arange(t)[None, :, None] / t
        tracks = (center + radius * np.sin(2 * np.pi * freq * time + phase)).astype(np.float32)
        visible = (rng.uniform(size=(n, t, 1)) > 0.2).astype(np.float32)
        example = {"tracks_3d" if c == 3 else "tracks": tracks, "visible": visible}
        if self.with_features:
            example["dino_features"] = rng.normal(0, 0.1, (n, t, 768)).astype(np.float32)
            example["depth_features"] = rng.normal(0, 0.1, (n, t, 256)).astype(np.float32)
        return example


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


class TfdsTrackProvider:
    """Examples from a ``tensorflow_datasets`` dataset (fields video /
    tracks_3d / visible [+ dino/depth features]).

    Random access goes through ``tfds.data_source`` (ArrayRecord datasets);
    datasets without it are materialised once through ``tfds.as_numpy``.
    Common field spellings are normalised: ``target_points`` / ``tracks_XYZ``
    -> tracks, ``occluded`` -> visible.
    """

    def __init__(self, name: str, split: str = "train", data_dir: str | None = None):
        import tensorflow_datasets as tfds

        try:
            self._source = tfds.data_source(name, split=split, data_dir=data_dir)
        except Exception:  # noqa: BLE001 - not an ArrayRecord dataset
            self._source = list(tfds.as_numpy(tfds.load(name, split=split, data_dir=data_dir)))

    def __len__(self):
        return len(self._source)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, i: int) -> dict:
        return _normalize_tfds_example(self._source[i])


def _normalize_tfds_example(raw: dict) -> dict:
    """tfds example -> the provider schema used by batch prep / eval."""
    example: dict = {}
    if "tracks_3d" in raw or "tracks_XYZ" in raw:
        example["tracks_3d"] = np.asarray(raw.get("tracks_3d", raw.get("tracks_XYZ")), np.float32)
    elif "tracks" in raw or "target_points" in raw:
        example["tracks"] = np.asarray(raw.get("tracks", raw.get("target_points")), np.float32)
    if "visible" in raw:
        vis = np.asarray(raw["visible"], np.float32)
    elif "visibility" in raw:
        vis = np.asarray(raw["visibility"], np.float32)
    elif "occluded" in raw:
        vis = 1.0 - np.asarray(raw["occluded"], np.float32)
    else:
        key = "tracks_3d" if "tracks_3d" in example else "tracks"
        vis = np.ones(example[key].shape[:2], np.float32)
    example["visible"] = vis[..., None] if vis.ndim == 2 else vis
    for key in ("dino_features", "depth_features", "video", "queries_xyt",
                "query_points", "fx_fy_cx_cy", "intrinsics"):
        if key in raw:
            example[key] = np.asarray(raw[key])
    return example


class BatchedTrackDataset:
    """Iterates prepared batches of ``batch_size`` examples of a provider.

    Each pass draws a new order from ``default_rng(seed + epoch)`` when
    ``shuffle``; example ``i`` is prepared with seed ``i``. ``take(n)`` yields
    the first ``n`` batches of a pass.
    """

    def __init__(self, provider, batch_size: int, prepare_fn, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True):
        self.provider = provider
        self.batch_size = batch_size
        self.prepare_fn = prepare_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def take(self, n: int):
        for i, batch in enumerate(self):
            if i >= n:
                return
            yield batch

    def __len__(self):
        n = len(self.provider) // self.batch_size
        if not self.drop_remainder and len(self.provider) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.arange(len(self.provider))
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(order)
        self._epoch += 1
        parts = []
        for idx in order:
            parts.append(self.prepare_fn(self.provider[int(idx)], seed=int(idx)))
            if len(parts) == self.batch_size:
                yield _concat_batches(parts)
                parts = []
        if parts and not self.drop_remainder:
            yield _concat_batches(parts)


def _concat_batches(parts: list[dict]) -> dict:
    return {k: np.concatenate([np.asarray(p[k]) for p in parts], axis=0) for k in parts[0]}


def _resolve_provider(dataset_path: str, split: str, coords: int, with_features: bool,
                      num_frames: int = 24):
    if dataset_path and os.path.isdir(dataset_path):
        return NpzDirectoryProvider(dataset_path, split=split)
    if dataset_path:
        # A path that is not a directory names a tfds dataset. A missing tfds
        # must not fall through to synthetic data: a dataset was asked for.
        try:
            import tensorflow_datasets  # noqa: F401
        except ImportError as e:
            raise ImportError(
                f"dataset_path={dataset_path!r} is not a directory, so it is "
                "treated as a tfds dataset name, but tensorflow_datasets is "
                "not installed. Install tfds, or pass an npz directory, or "
                "pass no dataset_path for synthetic data."
            ) from e
        return TfdsTrackProvider(dataset_path, split=split,
                                 data_dir=os.environ.get("TFDS_DATA_DIR"))
    # 128 videos: at least one full batch at the reference's batch of 64.
    return SyntheticTrackProvider(num_videos=128, num_coords=coords,
                                  with_features=with_features, num_frames=num_frames)


def load_kubric3d_dataset(dataset_path: str, split: str = "train", batch_size: int = 64,
                          shuffle: bool = True, num_support_tracks: int = 2048,
                          num_query_tracks: int = 2048, num_frames: int = 150,
                          use_dino: bool = True, use_depth: bool = True) -> BatchedTrackDataset:
    """Kubric3D-style training data for 3DSPA (synthetic without a dataset)."""
    provider = _resolve_provider(dataset_path, split, 3, use_dino or use_depth,
                                 num_frames=num_frames)

    def prepare(example, seed=None):
        return prepare_3d_batch(
            example,
            num_support_tracks=min(num_support_tracks, _num_tracks(example) // 2),
            num_query_tracks=min(num_query_tracks, _num_tracks(example) // 2),
            num_frames=num_frames, use_dino=use_dino, use_depth=use_depth, seed=seed,
        )

    return BatchedTrackDataset(provider, batch_size, prepare, shuffle=shuffle)


def load_tapvid_dataset(dataset_path: str, split: str = "train", batch_size: int = 64,
                        shuffle: bool = True, num_support_tracks: int = 2048,
                        num_query_tracks: int = 2048,
                        num_frames: int = 150) -> BatchedTrackDataset:
    """TAPVid-style 2D training data for TRAJAN (synthetic without a dataset)."""
    provider = _resolve_provider(dataset_path, split, 2, False, num_frames=num_frames)

    def prepare(example, seed=None):
        return prepare_2d_batch(
            example,
            num_support_tracks=min(num_support_tracks, _num_tracks(example) // 2),
            num_query_tracks=min(num_query_tracks, _num_tracks(example) // 2),
            num_frames=num_frames, seed=seed,
        )

    return BatchedTrackDataset(provider, batch_size, prepare, shuffle=shuffle)


def load_tapvid3d_dataset(dataset_path: str, split: str = "minival"):
    """TAPVid-3D evaluation data: raw per-video examples (the harness builds
    its own batches from the ground-truth queries)."""
    if dataset_path and os.path.isdir(dataset_path):
        return NpzDirectoryProvider(dataset_path, split=split)
    return TfdsTrackProvider(dataset_path, split=split, data_dir=os.environ.get("TFDS_DATA_DIR"))


def _num_tracks(example: dict) -> int:
    return int(np.asarray(example["tracks_3d" if "tracks_3d" in example else "tracks"]).shape[0])
