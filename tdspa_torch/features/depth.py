"""Host depth provider (port of ``tdspa/features/depth.py::ConstantDepthProvider``).

The video-depth network comes with the depth slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


class ConstantDepthProvider:
    """Unit depth everywhere (the reference's z = 1 fallback)."""

    def __call__(self, video, fps: float = 30.0) -> np.ndarray:
        t, h, w = video.shape[:3]
        return np.ones((t, h, w, 1), np.float32)
