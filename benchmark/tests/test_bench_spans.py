"""The spans' reduction (``harness/spans.py``) on synthetic event lists: a
device operation goes to every span that holds its launch, on any thread;
overlaps count once; busy time outside every span is kept; the device
timeline's own reduction is the same with and without span events."""

import dataclasses
import types

import pytest

from benchmark.harness.spans import SpanSummary, SpanTracer, is_launch
from benchmark.harness.trace import Summary, Tracer


def test_attribution_by_correlation_across_threads_and_nested_spans():
    s = SpanSummary()
    requests = [(0.0, 10.0)]
    spans = [("tdspa.train.step", 0.0, 9.0),  # main thread
             ("tdspa.train.forward", 0.5, 3.0),
             ("tdspa.train.backward", 3.0, 8.0),
             ("tdspa.model.encode_tracks", 4.0, 5.0)]  # autograd's thread, inside backward
    launches = {1: 1.0, 2: 4.5, 3: 6.0, 4: 9.5}  # 4: launched outside every span
    device = [("k", 1, 1.1, 2.0), ("k", 2, 4.6, 5.6), ("k", 3, 6.0, 7.0), ("k", 4, 9.6, 9.9)]
    s.add_cycle(requests, [(n, a, b) for n, _, a, b in device], [])
    s.add_spans(requests, device, spans, launches)
    got = {name: entry[2] for name, entry in s.spans.items()}
    assert got["tdspa.train.forward"] == pytest.approx(0.9)
    assert got["tdspa.model.encode_tracks"] == pytest.approx(1.0)  # ends past its span
    assert got["tdspa.train.backward"] == pytest.approx(2.0)
    assert got["tdspa.train.step"] == pytest.approx(2.9)
    assert s.spans["tdspa.train.backward"][:2] == [1, 5.0]
    assert s.covered_s == pytest.approx(2.9)
    assert s.uncovered_s == pytest.approx(0.3)
    assert s.launched == 4 and s.unlaunched == {}
    # Idle time under the innermost span open at the gap's middle: [0, 1.1]
    # forward; [2, 4.6] backward; [5.6, 6] backward (encode_tracks ended at
    # 5); [7, 9.6] step; [9.9, 10] outside every span.
    assert s.idle == pytest.approx({"tdspa.train.forward": 1.1,
                                    "tdspa.train.backward": 2.6 + 0.4,
                                    "tdspa.train.step": 2.6, "outside any span": 0.1})


def test_overlapping_operations_count_once_and_the_window_clips():
    s = SpanSummary()
    requests = [(0.0, 4.0)]
    spans = [("tdspa.tail", 0.0, 3.0)]
    device = [("k", 1, 1.0, 2.0), ("k", 2, 1.5, 2.5), ("k", 3, 3.5, 5.0),
              ("void Memset(int)", 9, 0.2, 0.4)]
    launches = {1: 0.5, 2: 0.6, 3: 2.9}  # 9: no launch found
    s.add_cycle(requests, [(n, a, b) for n, _, a, b in device], [])
    s.add_spans(requests, device, spans, launches)
    assert s.spans["tdspa.tail"][2] == pytest.approx(1.5 + 0.5)  # [1, 2.5] and [3.5, 4]
    assert s.busy_s == pytest.approx(2.2)
    assert s.uncovered_s == pytest.approx(0.2)  # the operation with no launch
    assert s.launched == 3 and s.unlaunched == {"Memset": [1, pytest.approx(0.2)]}
    s.add_spans([(10.0, 11.0)], [("k", 5, 10.0, 10.5)], [("tdspa.tail", 10.0, 11.0)], {5: 10.0})
    assert s.spans["tdspa.tail"][:2] == [2, 4.0]


def test_device_ms_per_request_and_missing_spans():
    s = SpanSummary(requests=2)
    s.spans = {"tdspa.tail.lift": [2, 0.1, 0.002], "tdspa.tail.split": [2, 0.1, 0.004]}
    assert s.device_ms(["tdspa.tail.lift", "tdspa.tail.split"]) == pytest.approx(3.0)
    assert s.device_ms(["tdspa.tail.lift", "tdspa.tail.sample"]) is None
    assert SpanSummary().device_ms(["tdspa.tail.lift"]) is None
    line = s.line()
    assert line["spans"]["tdspa.tail.lift"] == {"calls": 1.0, "host_ms": 50.0,
                                                "device_ms": pytest.approx(1.0)}


def test_launch_calls_are_named_by_the_cuda_apis():
    assert all(map(is_launch, ("cudaLaunchKernel", "cudaMemcpyAsync", "cuLaunchKernelEx")))
    assert not any(map(is_launch, ("aten::cumsum", "cudnn_convolution", "tdspa.tail")))


@dataclasses.dataclass
class _Event:
    """The parts of a kineto event the reductions read."""
    name_: str
    start: int
    duration: int
    device: str = "DeviceType.CPU"
    correlation: int = 0
    annotation: bool = False

    def name(self):
        return self.name_

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.duration

    def device_type(self):
        return self.device

    def correlation_id(self):
        return self.correlation

    def is_user_annotation(self):
        return self.annotation


def _prof(events):
    """What ``Tracer._reduce`` reads of a ``torch.profiler.profile``."""
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def _timeline(with_spans: bool):
    cuda = "DeviceType.CUDA"
    events = [
        _Event("bench.request", 1000, 9000, annotation=True),
        _Event("aten::mm", 2000, 500, correlation=7),
        _Event("cudaLaunchKernel", 2100, 100, correlation=41),
        _Event("gemm_kernel", 2500, 2000, cuda, correlation=41),
        _Event("cudaLaunchKernel", 6000, 100, correlation=42),
        _Event("elementwise_kernel", 6200, 1000, cuda, correlation=42),
        _Event("cudaDeviceSynchronize", 7300, 2500),
    ]
    if with_spans:
        events += [_Event("tdspa.tail", 1500, 8000, annotation=True),
                   _Event("tdspa.tail.model", 1900, 2600, annotation=True),
                   _Event("tdspa.tail", 2500, 2000, cuda, correlation=99, annotation=True)]
    return events


def test_the_device_timeline_is_the_same_with_and_without_span_events():
    plain, spanned = Tracer(1, 1, 1, 1), SpanTracer(1, 1, 1, 1)
    plain._reduce(_prof(_timeline(False)))
    spanned._reduce(_prof(_timeline(True)))
    a, b = plain.summary, spanned.summary
    assert (a.window_s, a.busy_s, a.requests, a.ops) == (b.window_s, b.busy_s, b.requests, b.ops)
    assert [g[0] for g in a.gaps] == [g[0] for g in b.gaps]
    assert isinstance(a, Summary) and not hasattr(a, "spans")
    assert b.spans["tdspa.tail.model"][2] == pytest.approx(2e-6)  # the GEMM alone
    assert b.spans["tdspa.tail"][2] == pytest.approx(3e-6)
    assert b.covered_s == pytest.approx(b.busy_s)
    assert b.line()["covered_share"] == pytest.approx(1.0)
    # Idle gaps inside a request take the innermost span that was open.
    assert "tdspa.tail" in {label for _, label in b.gaps}
    assert b.device_annotations == 0  # the device-side range is flagged as an annotation
