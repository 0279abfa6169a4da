"""Device timeline of a traced run, reduced in memory.

``torch.profiler`` records a few whole requests spread over the window (a
schedule from the traffic file: ``wait`` requests untraced, ``warmup``, then
``active`` traced, ``repeat`` times). Each cycle is reduced as it closes and
its events dropped: nothing is written to disk.

Per cycle the traced window runs from the start of its first request span
(``bench.request``, recorded by the harness around each request) to the end
of its last. Busy time is the union of the device operations' intervals
(kernels, copies, sets) inside it, so overlapping operations count once;
idle time is the rest. Each idle gap is named by the innermost host operation
that covers its middle, or ``host outside any op`` (Python or NumPy work).
"""

from __future__ import annotations

import dataclasses

REQUEST_SPAN = "bench.request"
NO_OP = "host outside any op"


def canonical(name: str) -> str:
    """A kernel's short name: no return type, anonymous namespace, argument
    or template list, the last scope only."""
    short = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        short = short.split(cut, 1)[0] or short
    return (short.rsplit("::", 1)[-1].strip() or name.strip())[:120]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Summary:
    """Seconds summed over the traced cycles."""

    window_s: float = 0.0
    busy_s: float = 0.0
    requests: int = 0
    ops: dict = dataclasses.field(default_factory=dict)  # name -> [launches, seconds]
    gaps: list = dataclasses.field(default_factory=list)  # (seconds, label)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def seconds_of(self, kernels) -> float:
        return sum(s for name, (_, s) in self.ops.items() if any(k in name for k in kernels))

    def launches_of(self, kernels) -> int:
        return sum(n for name, (n, _) in self.ops.items() if any(k in name for k in kernels))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:top]
        return {"device_ops": [[name, s] for name, (_, s) in ops],
                "idle_gaps": [[label, s] for s, label in gaps]}

    def add_cycle(self, requests, device, host, keep_gaps: int = 10) -> None:
        """One cycle from seconds-valued events: ``requests`` [(start, end)],
        ``device`` [(name, start, end)], ``host`` [(name, start, end)]."""
        if not requests:
            return
        lo = min(s for s, _ in requests)
        hi = max(e for _, e in requests)
        self.window_s += hi - lo
        self.requests += len(requests)
        clipped = []
        for name, start, end in device:
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            clipped.append((start, end))
            entry = self.ops.setdefault(canonical(name), [0, 0.0])
            entry[0] += 1
            entry[1] += end - start
        busy = union(clipped)
        self.busy_s += sum(e - s for s, e in busy)
        edges = [lo] + [x for seg in busy for x in seg] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        for length, start, end in sorted(gaps, reverse=True)[:keep_gaps]:
            self.gaps.append((length, _label(host, (start + end) / 2)))
        self.gaps = sorted(self.gaps, reverse=True)[:keep_gaps]


def _label(host, t: float) -> str:
    best = None
    for name, start, end in host:
        if start <= t <= end and (best is None or end - start < best[1]):
            best = (name, end - start)
    return best[0] if best else NO_OP


class Tracer:
    """A ``torch.profiler`` over the window's requests; ``step()`` after each."""

    def __init__(self, wait: int, warmup: int, active: int, repeat: int):
        import torch.profiler as tp

        self.summary = Summary()
        self._profiler = tp.profile(
            activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA],
            schedule=tp.schedule(wait=wait, warmup=warmup, active=active, repeat=repeat),
            on_trace_ready=self._reduce,
        )

    def __enter__(self):
        self._profiler.__enter__()
        return self

    def __exit__(self, *exc):
        return self._profiler.__exit__(*exc)

    def step(self, _i=None) -> None:
        self._profiler.step()

    def _reduce(self, prof) -> None:
        requests, device, host = [], [], []
        events = prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)  # seconds stay exact in f64
        for e in events:
            name = e.name()
            start = e.start_ns() - base
            span = (start * 1e-9, (start + e.duration_ns()) * 1e-9)
            if str(e.device_type()).endswith("CPU"):
                if name == REQUEST_SPAN:
                    requests.append(span)
                elif not name.startswith(("ProfilerStep", "bench.")):
                    host.append((name, *span))
            elif not (getattr(e, "is_user_annotation", lambda: False)()
                      or name.startswith(("ProfilerStep", "bench."))):
                device.append((name, *span))
        self.summary.add_cycle(requests, device, host)
