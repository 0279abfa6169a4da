"""The port's spans (``tdspa_torch/utils/profiling.py::span``) on the CPU:
recorded only while a ``torch.profiler`` records, named by layer, nested in
time as the layers call each other."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.profiler as tp

from tdspa_torch.infer.pipeline import fused_tail
from tdspa_torch.train.state import TrainState, create_optimizer
from tdspa_torch.train.step import make_grad_accum_step, make_train_step
from tdspa_torch.utils import profiling
from tdspa_torch.utils.testing import synthetic_batch, tiny_model_2d, tiny_model_3d, to_torch

T, H, W = 10, 32, 40
N_TRACKS, N_SUPPORT, N_QUERIES = 16, 10, 6
TAIL_PARTS = ("tdspa.tail.lift", "tdspa.tail.sample", "tdspa.tail.split", "tdspa.tail.model")


def _spans(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of every ``tdspa.`` range, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("tdspa.")), key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _tail_args():
    rng = np.random.default_rng(1)
    tracks = rng.uniform(0, W - 1.0, (N_TRACKS, T, 2)).astype(np.float32)
    visible = (rng.uniform(size=(N_TRACKS, T, 1)) > 0.2).astype(np.float32)
    dino = rng.standard_normal((T, 3, 3, 768)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (T, H, W, 1)).astype(np.float32)
    perm = torch.from_numpy(rng.permutation(N_TRACKS))
    ts = torch.from_numpy(rng.integers(0, T, N_QUERIES))
    return (*(torch.from_numpy(x) for x in (tracks, visible, dino, depth)), perm, ts,
            N_SUPPORT, N_QUERIES, (H, W))


def test_off_the_span_is_the_shared_no_op_and_records_nothing(monkeypatch):
    """With no profiler recording (none at all, or one in its schedule's
    wait or warmup step) a span is one shared context and never reaches
    ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with the profiler off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span("tdspa.a") is profiling.span("tdspa.b")
    with profiling.span("tdspa.a"), profiling.span("tdspa.a"):  # reentrant
        pass
    with tp.profile(activities=[tp.ProfilerActivity.CPU],
                    schedule=tp.schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in ("wait", "warmup"):
            with profiling.span("tdspa.off"):
                torch.ones(3).sum()
            prof.step()
        monkeypatch.undo()
        with profiling.span("tdspa.on"):
            torch.ones(3).sum()
        prof.step()
    names = [s[0] for s in _spans(prof)]
    assert names == ["tdspa.on"]


def test_stage_timer_opens_its_span():
    sink = {}
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        with profiling.stage_timer("fused_tail", sink):
            torch.ones(3).sum()
    assert [s[0] for s in _spans(prof)] == ["tdspa.video.fused_tail"]
    assert set(sink) == {"fused_tail"}


def test_fused_tail_records_its_parts_and_the_model_in_order():
    model = tiny_model_3d(T, device="cpu", seed=3)
    args = _tail_args()
    with torch.no_grad():
        fused_tail(model, *args)  # warm
        with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
            fused_tail(model, *args)
    spans = _spans(prof)
    (tail,) = _named(spans, "tdspa.tail")
    parts = [_named(spans, name) for name in TAIL_PARTS]
    assert all(len(p) == 1 for p in parts), spans
    parts = [p[0] for p in parts]
    assert all(_inside(p, tail) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # one after another
    model_span = parts[-1]
    for name in ("tdspa.model.encode_tracks", "tdspa.model.latents", "tdspa.model.decode"):
        (s,) = _named(spans, name)
        assert _inside(s, model_span), (name, spans)
    encode, latents, decode = (_named(spans, f"tdspa.model.{n}")[0]
                               for n in ("encode_tracks", "latents", "decode"))
    assert encode[2] <= latents[1] and latents[2] <= decode[1]


@pytest.mark.parametrize("accumulate", [False, True])
def test_train_step_records_forward_backward_and_optimizer(accumulate):
    """A tiny 2D step with encoder chunks: forward, backward and optimizer
    inside the step, one after another; each chunk's encoder span once in
    the forward and once more in the backward, where the remat recomputes
    it; decoder chunks in the forward."""
    model = tiny_model_2d(T, device="cpu", encoder_scan_chunk_size=4,
                          decoder_scan_chunk_size=2)
    optimizer, schedule = create_optimizer(1e-3, 0, 10, 0.01, 1.0)
    params = dict(model.named_parameters())
    state = TrainState(params=params, opt_state=optimizer.init(params), step=0)
    batch = to_torch(synthetic_batch(0, batch=2, num_support=8, num_queries=4, num_frames=T,
                                     num_coords=2))
    step = (make_grad_accum_step(model, optimizer, schedule, num_microbatches=2) if accumulate
            else make_train_step(model, optimizer, schedule))
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batch)
    spans = _spans(prof)
    (train,) = _named(spans, "tdspa.train.step")
    microbatches = 2 if accumulate else 1
    forward, backward = _named(spans, "tdspa.train.forward"), _named(spans, "tdspa.train.backward")
    (optimizer_span,) = _named(spans, "tdspa.train.optimizer")
    assert len(forward) == len(backward) == microbatches
    order = sorted(forward + backward, key=lambda s: s[1]) + [optimizer_span]
    assert [s[0] for s in order[:-1]] == ["tdspa.train.forward", "tdspa.train.backward"] * \
        microbatches
    assert all(_inside(s, train) for s in order)
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    chunks = 8 // 4
    encodes = _named(spans, "tdspa.model.encode_tracks")
    assert len(encodes) == 2 * chunks * microbatches
    for f, b in zip(forward, backward):
        assert sum(_inside(s, f) for s in encodes) == chunks
        assert sum(_inside(s, b) for s in encodes) == chunks  # the recompute
        assert sum(_inside(s, f) for s in _named(spans, "tdspa.model.decode")) == 4 // 2
        assert sum(_inside(s, f) for s in _named(spans, "tdspa.model.latents")) == 1
    assert not _named(spans, "tdspa.train.mesh_sum")
