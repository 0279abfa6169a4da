"""Tracing hook of the CLIs (port of ``profile_trace`` in
``tdspa/utils/profiling.py``; the rest of that module serves JAX's compile
and NaN debugging and has no counterpart here)."""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` scope (host and, where present, CUDA activity) that
    writes a Chrome/Perfetto trace ``trace_<time>.json`` into ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
