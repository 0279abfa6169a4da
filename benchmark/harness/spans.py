"""Device time of the program's layers, read from its spans in a traced run.

The port marks its layer boundaries with ranges named ``tdspa.*``
(``tdspa_torch/utils/profiling.py::span``: the tail and its parts, the
model's encoder, latents and decoder, the training step's forward, backward
and optimizer). They are recorded only while the profiler records, on the
host clock that the device trace shares.

A device operation belongs to every span whose host interval, on any thread,
holds the operation's launch: the host runtime call (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...) that carries the operation's
correlation id. So work that autograd's worker thread launches counts under
``tdspa.train.backward``, which the main thread holds open meanwhile. A
span's device seconds are the union of its operations' intervals inside the
traced window, so overlapping operations count once; the busy seconds of
operations that no span holds are kept beside (``uncovered_s``), and each
idle second of the window under the innermost span open at its gap's middle
(``idle``).

``SpanTracer`` is ``trace.Tracer`` with a ``SpanSummary``: everything
``Summary`` reads (window, busy time, operations, idle gaps) is reduced by
``Tracer`` itself, unchanged; the spans are a second pass over the same
events.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.harness.trace import (NO_OP, REQUEST_SPAN, Summary, Tracer, _label, canonical,
                                     union)

SPAN_PREFIX = "tdspa."
NO_SPAN = "outside any span"


def is_launch(name: str) -> bool:
    """A host call of the CUDA runtime API (``cuda*``) or of its lower level (``cu[A-Z]*``)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


@dataclasses.dataclass
class SpanSummary(Summary):
    """``Summary`` and, per span name, [calls, host seconds, device seconds],
    summed over the traced cycles."""

    spans: dict = dataclasses.field(default_factory=dict)
    idle: dict = dataclasses.field(default_factory=dict)  # innermost open span -> seconds
    covered_s: float = 0.0
    launched: int = 0  # device operations whose launch was found
    unlaunched: dict = dataclasses.field(default_factory=dict)  # name -> [count, seconds]
    device_annotations: int = 0  # device-side ``tdspa.`` ranges not flagged as annotations

    @property
    def uncovered_s(self) -> float:
        return self.busy_s - self.covered_s

    def add_spans(self, requests, device, spans, launches) -> None:
        """One cycle from seconds-valued events: ``requests`` [(start, end)],
        ``device`` [(name, correlation id, start, end)], ``spans`` [(name,
        start, end)] and ``launches`` {correlation id: host time of the
        launch}."""
        if not requests:
            return
        lo = min(s for s, _ in requests)
        hi = max(e for _, e in requests)
        spans = [(n, s, e) for n, s, e in spans if lo <= s <= hi]
        ops, at, busy = [], [], []
        for name, corr, start, end in device:
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            busy.append((start, end))
            if corr in launches:
                ops.append((start, end))
                at.append(launches[corr])
            else:
                entry = self.unlaunched.setdefault(canonical(name), [0, 0.0])
                entry[0] += 1
                entry[1] += end - start
        self.launched += len(ops)
        starts = np.array([s for _, s, _ in spans], dtype=np.float64)
        ends = np.array([e for _, _, e in spans], dtype=np.float64)
        t = np.array(at, dtype=np.float64)[:, None]
        holds = (starts[None, :] <= t) & (t <= ends[None, :])  # [operation, span]
        names = sorted({n for n, _, _ in spans})
        for name in names:
            cols = [j for j, (n, _, _) in enumerate(spans) if n == name]
            mine = np.flatnonzero(holds[:, cols].any(axis=1))
            entry = self.spans.setdefault(name, [0, 0.0, 0.0])
            entry[0] += len(cols)
            entry[1] += sum(min(spans[j][2], hi) - spans[j][1] for j in cols)
            entry[2] += _seconds(union([ops[i] for i in mine]))
        covered = np.flatnonzero(holds.any(axis=1))
        self.covered_s += _seconds(union([ops[i] for i in covered]))
        edges = [lo] + [x for seg in union(busy) for x in seg] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                label = _label(spans, (a + b) / 2)
                label = NO_SPAN if label == NO_OP else label
                self.idle[label] = self.idle.get(label, 0.0) + b - a

    def device_ms(self, names) -> float | None:
        """Device ms per traced request of the named spans together (each
        span's own union, summed: spans that nest must not be named
        together); ``None`` unless every one was recorded."""
        if not self.requests or any(n not in self.spans for n in names):
            return None
        return 1e3 * sum(self.spans[n][2] for n in names) / self.requests

    def line(self) -> dict:
        """Per traced request: each span's calls, host ms and device ms; the
        share of the busy time that spans hold."""
        r = max(self.requests, 1)
        return {"requests": self.requests,
                "covered_share": self.covered_s / self.busy_s if self.busy_s > 0 else None,
                "uncovered_ms": 1e3 * self.uncovered_s / r,
                "busy_ms": 1e3 * self.busy_s / r,
                "launch_found": self.launched / max(self.launched + sum(
                    n for n, _ in self.unlaunched.values()), 1),
                "unlaunched_ms": {k: 1e3 * v / r for k, (_, v) in self.unlaunched.items()},
                "device_annotations": self.device_annotations,
                "spans": {name: {"calls": c / r, "host_ms": 1e3 * h / r, "device_ms": 1e3 * d / r}
                          for name, (c, h, d) in sorted(self.spans.items())},
                "idle_ms": {label: 1e3 * v / r for label, v in
                            sorted(self.idle.items(), key=lambda kv: -kv[1])}}


def _seconds(intervals) -> float:
    return sum(e - s for s, e in intervals)


class SpanTracer(Tracer):
    """``Tracer`` whose summary also holds the program's spans."""

    def __init__(self, wait: int, warmup: int, active: int, repeat: int):
        super().__init__(wait, warmup, active, repeat)
        self.summary = SpanSummary()

    def _reduce(self, prof) -> None:
        super()._reduce(prof)
        events = prof.profiler.kineto_results.events()
        self.summary.add_spans(*reduce_spans(events))
        self.summary.device_annotations += sum(
            1 for e in events if e.name().startswith(SPAN_PREFIX)
            and not str(e.device_type()).endswith("CPU")
            and not getattr(e, "is_user_annotation", lambda: False)())


def reduce_spans(events):
    """(requests, device, spans, launches) of one cycle's kineto events, in
    seconds from the cycle's first event (as ``Tracer`` counts them)."""
    requests, device, spans, launches = [], [], [], {}
    base = min((e.start_ns() for e in events), default=0)
    for e in events:
        name = e.name()
        start = e.start_ns() - base
        span = (start * 1e-9, (start + e.duration_ns()) * 1e-9)
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if str(e.device_type()).endswith("CPU"):
            if name == REQUEST_SPAN:
                requests.append(span)
            elif name.startswith(SPAN_PREFIX) and not name.startswith("tdspa::"):
                spans.append((name, *span))
            elif is_launch(name) and not annotation:
                launches[e.correlation_id()] = span[0]
        elif not (annotation or name.startswith(("ProfilerStep", "bench.", SPAN_PREFIX))):
            device.append((name, e.correlation_id(), *span))
    return requests, device, spans, launches
