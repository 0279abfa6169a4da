"""The measured window: requests or steps back to back on the host clock.

A window starts when its first request starts and ends when its last
completed request ends; every request inside counts. A rate is the window's
length over the requests it completed, a tail the percentile of all their
latencies, so a stall anywhere in the window moves both.
"""

from __future__ import annotations

import math
import time


class Window:
    def __init__(self):
        self.starts: list[float] = []
        self.ends: list[float] = []

    def record(self, start: float, end: float) -> None:
        self.starts.append(start)
        self.ends.append(end)

    @property
    def count(self) -> int:
        return len(self.ends)

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0] if self.ends else 0.0

    @property
    def latencies(self) -> list[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]

    def mean_s(self) -> float:
        """Window length over completed requests."""
        return self.seconds / self.count

    def percentile_s(self, q: float) -> float:
        return percentile(self.latencies, q)


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of the
    values at or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def run(request, seconds: float, after=None, clock=time.perf_counter) -> Window:
    """Call ``request(i)`` back to back, each returning once its work is
    done, starting new ones until ``seconds`` have passed since the first
    started; ``after(i)`` runs between requests, outside their latency."""
    window = Window()
    first = None
    i = 0
    while first is None or clock() - first < seconds:
        start = clock()
        if first is None:
            first = start
        request(i)
        window.record(start, clock())
        if after is not None:
            after(i)
        i += 1
    return window
