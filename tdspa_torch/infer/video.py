"""Video file I/O (port of ``tdspa/infer/video.py``).

``cv2`` is imported inside each function, as in the JAX package, so that
the rest of the port imports without OpenCV.
"""

from __future__ import annotations

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading or writing a video file needs OpenCV (the cv2 package, e.g. "
            "opencv-python-headless); in-memory videos go through "
            "InferencePipeline.run_on_frames without it"
        ) from e
    return cv2


def load_video(video_path: str, max_frames: int | None = None):
    """Read frames (BGR->RGB), capped at max_frames. Returns (frames, fps)."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"Could not open video file: {video_path}")
    frames = []
    fps = cap.get(cv2.CAP_PROP_FPS)
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        if max_frames and len(frames) >= max_frames:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"No frames loaded from video: {video_path}")
    return np.array(frames), fps


def save_video(frames_rgb: np.ndarray, video_path: str, fps: float = 30.0) -> None:
    """Write [T H W 3] RGB uint8 frames as mp4 (avc1 with mp4v fallback)."""
    cv2 = _cv2()
    height, width = frames_rgb.shape[1:3]
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"avc1"), fps, (width, height))
    if not writer.isOpened():
        writer = cv2.VideoWriter(
            video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
    for frame in frames_rgb:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
