"""Tracing and timing hooks (port of ``tdspa/utils/profiling.py``).

* ``stage_timer`` — wall-clock a pipeline stage, synchronising the current
  CUDA device first so that queued device work is inside the stage;
  accumulates into a dict.
* ``profile_trace`` — ``torch.profiler`` scope writing a Chrome/Perfetto
  trace.
* ``debug_nans`` — the NaN check of ``utils/debug.py`` for a scope.
* ``log_compile_time`` — first-call vs steady-state time of a function.
  PyTorch runs eagerly and has no compile step: the first call's extra time
  is the kernels' first-use build and load (``kernels/build.py``: ``nvcc``
  where no library is built yet) and the libraries' and allocator's first
  use.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage_timer(name: str, sink: dict | None = None):
    """Time a stage: seconds from entry to exit, with the current CUDA device
    synchronised at both ends where there is one; added to ``sink[name]``."""
    _synchronize()
    t0 = time.perf_counter()
    yield
    _synchronize()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    logger.info("[stage] %s: %.4fs", name, dt)


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


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope, the first operator whose floating output holds a NaN
    raises ``FloatingPointError`` naming it (``utils/debug.py``); with
    ``enable=False`` nothing is installed."""
    if not enable:
        yield
        return
    from tdspa_torch.utils.debug import NanCheckMode

    with NanCheckMode():
        yield


def log_compile_time(fn, *args, iters: int = 3, **kwargs):
    """Run ``fn`` once, then ``iters`` times; returns ``(first_s, steady_s,
    out)``: the first call's seconds (with the kernels' first-use build and
    load, PyTorch's counterpart of JAX's compile), the mean of the later
    calls, and the last output. The device is synchronised around each
    measurement."""
    _synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _synchronize()
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _synchronize()
    steady_s = (time.perf_counter() - t0) / iters
    logger.info("first=%.3fs steady=%.4fs", first_s, steady_s)
    return first_s, steady_s, out
