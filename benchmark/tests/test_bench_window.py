"""The window's arithmetic: a rate over every request and all the time, a
tail over every latency, and a stall that moves both."""

from benchmark.harness import window as window_mod
from benchmark.harness.window import Window, percentile


class FakeClock:
    """A clock that each request moves by its own duration."""

    def __init__(self, durations, gap=0.0):
        self.now, self.durations, self.gap = 0.0, list(durations), gap

    def __call__(self):
        return self.now

    def request(self, i):
        self.now += self.durations[i % len(self.durations)]

    def after(self, i):
        self.now += self.gap


def test_rate_is_the_whole_window_over_its_requests():
    w = Window()
    for start, end in [(0.0, 1.0), (1.0, 2.5), (2.5, 3.0)]:
        w.record(start, end)
    assert w.count == 3
    assert w.seconds == 3.0
    assert w.mean_s() == 1.0
    assert w.latencies == [1.0, 1.5, 0.5]


def test_time_between_requests_counts_in_the_rate_not_the_latency():
    clock = FakeClock([0.1], gap=0.05)
    w = window_mod.run(clock.request, 1.0, after=clock.after, clock=clock)
    assert all(abs(x - 0.1) < 1e-12 for x in w.latencies)
    assert w.mean_s() > 0.1


def test_window_stops_after_its_seconds_and_finishes_the_last_request():
    clock = FakeClock([0.3])
    w = window_mod.run(clock.request, 1.0, clock=clock)
    assert w.count == 4  # starts at 0, 0.3, 0.6, 0.9; the last ends at 1.2
    assert abs(w.seconds - 1.2) < 1e-12


def test_p95_is_nearest_rank_over_every_latency():
    values = [float(i) for i in range(1, 101)]
    assert percentile(values, 95) == 95.0
    assert percentile(values, 100) == 100.0
    assert percentile([5.0], 95) == 5.0
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_a_stall_inside_the_window_moves_rate_and_tail():
    durations = [0.1] * 100
    for i in range(40, 46):  # six requests stall, 6 % of the window's requests
        durations[i] = 0.5
    clock = FakeClock(durations)
    stalled = window_mod.run(clock.request, 10.0, clock=clock)
    clock = FakeClock([0.1])
    steady = window_mod.run(clock.request, 10.0, clock=clock)
    assert stalled.mean_s() > steady.mean_s() * 1.1
    assert stalled.percentile_s(95) >= 0.5 > steady.percentile_s(95)
