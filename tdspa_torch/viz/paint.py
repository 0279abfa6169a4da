"""Track visualization: score-colored points with motion trails on video
(the port's own copy of ``tdspa/viz/paint.py``, which uses only NumPy and
OpenCV; the port imports nothing of the JAX package).

Capability contract from reference visualize.py / visualizer.py: npz in
(coords [T,N,3], coords_score [T,N], video [T,C,H,W], intrinsics,
extrinsics, visibs) -> mp4 (+ optional PNG frames) out, with the
red(0) -> white(0.5) -> blue(1) score colormap, ``trail``-frame motion
trails at 0.7-alpha, and circle markers. All trail segments of a frame are
drawn on one overlay and blended once, as in the JAX package.

``cv2`` is imported where it is used, with a clear error when it is
missing, as in ``infer/video.py``; PNG frames are written with ``cv2``
rather than ``imageio`` (both lossless: the same pixels).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "track visualization needs OpenCV (the cv2 package, e.g. opencv-python-headless)"
        ) from e
    return cv2


def score_to_color_bgr(score: float) -> tuple[int, int, int]:
    """Red (0) -> White (0.5) -> Blue (1), BGR for OpenCV
    (reference visualize.py:47-73)."""
    s = float(np.clip(score, 0, 1))
    if s < 0.5:
        ratio = s / 0.5
        return (int(255 * ratio), int(255 * ratio), 255)
    ratio = (s - 0.5) / 0.5
    return (255, int(255 * (1 - ratio)), int(255 * (1 - ratio)))


def scores_to_colors_bgr(scores: np.ndarray) -> np.ndarray:
    """Vectorized colormap: float[...] in [0,1] -> uint8[..., 3] BGR."""
    s = np.clip(np.asarray(scores, np.float32), 0, 1)
    low = s < 0.5
    ratio_low = s / 0.5
    ratio_high = (s - 0.5) / 0.5
    r = np.where(low, 255, 255 * (1 - ratio_high))
    g = np.where(low, 255 * ratio_low, 255 * (1 - ratio_high))
    b = np.where(low, 255 * ratio_low, 255)
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def normalize_scores(scores: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Min-max normalize to [0, 1] (reference visualizer.py:23-45)."""
    if not normalize:
        return scores
    lo, hi = scores.min(), scores.max()
    if hi > lo:
        return (scores - lo) / (hi - lo)
    return scores - lo


def paint_point_track_with_colors(
    video: np.ndarray,  # [T H W 3] BGR uint8
    tracks: np.ndarray,  # [N T 2] (x, y)
    visibles,  # optional [N T] bool
    scores: np.ndarray,  # [T N]
    trail: int = 5,
    point_size: int = 2,
) -> np.ndarray:
    """Draw score-colored points + trails; returns a painted copy."""
    cv2 = _cv2()
    video_viz = video.copy()
    total_frames, height, width, _ = video.shape
    num_tracks = tracks.shape[0]
    colors = scores_to_colors_bgr(scores)  # [T N 3]

    for t in range(min(tracks.shape[1], total_frames)):
        frame = video_viz[t]
        # Trails: one overlay for the whole frame, blended once at 0.7 alpha.
        if trail > 0 and t > 0:
            overlay = frame.copy()
            drew = False
            start_t = max(0, t - trail)
            for i in range(num_tracks):
                color = tuple(int(c) for c in colors[t, i])
                for prev_t in range(start_t, t):
                    x0, y0 = int(tracks[i, prev_t, 0]), int(tracks[i, prev_t, 1])
                    x1, y1 = int(tracks[i, prev_t + 1, 0]), int(tracks[i, prev_t + 1, 1])
                    if (
                        0 <= x0 < width and 0 <= y0 < height
                        and 0 <= x1 < width and 0 <= y1 < height
                    ):
                        cv2.line(overlay, (x0, y0), (x1, y1), color, 1, cv2.LINE_AA)
                        drew = True
            if drew:
                frame = cv2.addWeighted(overlay, 0.7, frame, 0.3, 0)
        for i in range(num_tracks):
            x, y = int(tracks[i, t, 0]), int(tracks[i, t, 1])
            if 0 <= x < width and 0 <= y < height:
                cv2.circle(
                    frame, (x, y), point_size,
                    tuple(int(c) for c in colors[t, i]), -1,
                )
        video_viz[t] = frame
    return video_viz


def load_visualization_data(npz_path: str) -> dict:
    """Load the visualization npz contract (reference visualize.py:178-216)."""
    data = np.load(npz_path)
    coords = data["coords"]  # [T N 3]
    coords_score = data["coords_score"]
    video = data["video"]  # [T C H W]
    intrinsics = data["intrinsics"]
    extrinsics = data["extrinsics"]
    visibs = data["visibs"] if "visibs" in data else None

    num_frames = coords.shape[0]
    if intrinsics.ndim == 2:
        intrinsics = np.tile(intrinsics[None], (num_frames, 1, 1))
    if extrinsics.ndim == 2:
        extrinsics = np.tile(extrinsics[None], (num_frames, 1, 1))
    if visibs is not None:
        if visibs.ndim == 3:
            visibs = visibs[..., 0]
        visibs = visibs > 0.5
    else:
        visibs = np.ones(coords.shape[:2], bool)
    return {
        "coords": coords,
        "coords_score": np.squeeze(coords_score),
        "video": video,
        "intrinsics": intrinsics,
        "extrinsics": extrinsics,
        "visibs": visibs,
    }


def prepare_video_for_visualization(video: np.ndarray):
    """[T C H W] floats in [0,1] -> ([T H W 3] RGB uint8, same in BGR)."""
    cv2 = _cv2()
    video_rgb = np.transpose(video, (0, 2, 3, 1))
    video_rgb = (np.clip(video_rgb, 0, 1) * 255).astype(np.uint8)
    video_bgr = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2BGR) for f in video_rgb])
    return video_rgb, video_bgr


def save_video_opencv(video_bgr: np.ndarray, output_path, fps: int = 10) -> None:
    """avc1 with mp4v fallback (reference visualizer.py:48-67)."""
    cv2 = _cv2()
    height, width = video_bgr.shape[1:3]
    fourcc = cv2.VideoWriter_fourcc(*"avc1")
    writer = cv2.VideoWriter(str(output_path), fourcc, fps, (width, height))
    if not writer.isOpened():
        writer = cv2.VideoWriter(
            str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
    for frame in video_bgr:
        writer.write(frame)
    writer.release()


def save_frames(video_rgb: np.ndarray, output_dir) -> None:
    """One PNG per frame (reference visualizer.py:69-83)."""
    cv2 = _cv2()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(video_rgb):
        if not cv2.imwrite(str(output_dir / f"frame_{i:05d}.png"),
                           cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)):
            raise OSError(f"could not write {output_dir / f'frame_{i:05d}.png'}")
