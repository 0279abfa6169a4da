"""Work counts against hand counts at small shapes, and the shares built on
them, which can reach 100 % and no more when the device time is the bound."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import spec, weights
from benchmark.harness.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from benchmark.harness.trace import Summary
from benchmark.harness.window import Window
from benchmark.reference import tail as reference_tail
from benchmark.reference.model import Model, param_shapes
from benchmark.tests import tiny
from benchmark.work.attention import backward_bound_s, forward_bound_s, forward_calls
from benchmark.work.model_flops import forward_flops


def test_attention_bound_by_hand():
    # 8 items, 13 rows, 13 keys, 2 heads of 8, masked: q, k, v bf16 + f32 out + mask.
    call = ("encoder", 8, 13, 13, 2, 8, True)
    nbytes = 8 * 13 * 2 * 8 * 2 * 3 + 8 * 13 * 2 * 8 * 4 + 8 * 13
    flops = 2 * (2 * 8 * 2 * 13 * 13 * 8)  # q k^T and p v, 2 flops a multiply-add
    assert forward_bound_s(call) == pytest.approx(max(nbytes / PEAK_BYTES_PER_S,
                                                      flops / PEAK_BF16_FLOPS))
    # backward: q, k, v, dq, dk, dv bf16 + g f32 + mask; five products
    nbytes = 8 * 13 * 2 * 8 * (2 * 3 + 2 * 3 + 4) + 8 * 13
    flops = 5 * 2 * 8 * 2 * 13 * 13 * 8
    assert backward_bound_s(call) == pytest.approx(max(nbytes / PEAK_BYTES_PER_S,
                                                       flops / PEAK_BF16_FLOPS))


@pytest.mark.parametrize("workload", ["spa3d.tail", "trajan2d.train"])
def test_attention_calls_are_the_forwards(workload):
    cell = spec.cell(workload)
    cfg = cell["config"]
    calls = forward_calls(cfg, 1, 2048, 512, 150)
    layers = (cfg["input_track_layers"] + 2 * cfg["tracks_to_latents_layers"]
              + cfg["decompress_layers"] + cfg["readout_layers"])
    assert len(calls) == layers  # 19 (3DSPA), 21 (TRAJAN)


def test_tail_attention_bound_is_the_smoke_tests_figure():
    cfg = spec.cell("spa3d.tail")["config"]
    total = sum(forward_bound_s(c) for c in forward_calls(cfg, 1, 2048, 512, 150))
    assert total * 1e3 == pytest.approx(2.743, abs=5e-4)


@pytest.mark.parametrize("workload", ["spa3d.tail", "trajan2d.train"])
def test_model_flops_equal_the_references_products(workload):
    """Every matrix product the plain reference runs, counted by torch's
    flop counter, at a tiny size."""
    cell = tiny.cell(workload)
    cfg, t = cell["config"], cell["traffic"]
    w = weights.make(param_shapes(cfg), 1, "cpu")
    gen = torch.Generator().manual_seed(1)
    if cell["traffic"]["entry"] == "tail":
        from benchmark.harness import generate

        x = generate.front_ends(t, gen, "cpu")
        perms, ts = generate.splits(1, x["tracks"].shape[0], t["queries"], t["frames"], gen,
                                    "cpu")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            reference_tail.tail(Model(cfg, w), x["tracks"], x["visible"], x["dino"], x["depth"],
                                perms[0], ts[0], t["support"], t["queries"],
                                (t["height"], t["width"]))
        batch = 1
    else:
        from benchmark.harness import generate

        batch = cfg["batch_size"]
        b = generate.orbit_batch(t, batch, 2, gen, "cpu")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            Model(cfg, w)(b)
    want = forward_flops(cfg, batch, t["support"], t["queries"], t["frames"])
    assert counter.get_total_flops() == want


def _run(cell, seconds_per_request, requests=10, kernel_s=None, names=()):
    w = Window()
    for i in range(requests):
        w.record(i * seconds_per_request, (i + 1) * seconds_per_request)
    trace = Summary()
    trace.add_cycle([(0.0, requests * seconds_per_request)],
                    [(n, 0.0, kernel_s) for n in names], [])
    return types.SimpleNamespace(config=cell["config"], traffic=cell["traffic"], window=w,
                                 trace=trace, setup_s=1.0)


@pytest.mark.parametrize("name,workload,kernels", [
    ("attention_roofline.tail", "spa3d.tail", ["masked_attention_kernel"]),
    ("attention_backward_roofline.train", "trajan2d.train", ["attention_backward_kernel"]),
])
def test_roofline_reaches_100_percent_at_the_bound_and_no_more(name, workload, kernels):
    cell = spec.cell(workload)
    cfg, t = cell["config"], cell["traffic"]
    batch = cfg.get("batch_size", 1)
    calls = forward_calls(cfg, batch, t["support"], t["queries"], t["frames"])
    bound = forward_bound_s if "backward" not in name else backward_bound_s
    per_request = sum(bound(c) for c in calls)
    reader = spec.reader(name)
    run = _run(cell, 1.0, requests=1, kernel_s=per_request, names=kernels)
    assert reader.read(run) == pytest.approx(100.0)
    run = _run(cell, 1.0, requests=1, kernel_s=2 * per_request, names=kernels)
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(_run(cell, 1.0, requests=1, kernel_s=1.0, names=["other_kernel"])) is None


@pytest.mark.parametrize("name,workload,factor", [("mfu.tail", "spa3d.tail", 1),
                                                   ("mfu.train", "trajan2d.train", 3)])
def test_mfu_is_flops_over_window_over_peak(name, workload, factor):
    cell = spec.cell(workload)
    cfg, t = cell["config"], cell["traffic"]
    flops = factor * forward_flops(cfg, cfg.get("batch_size", 1), t["support"], t["queries"],
                                   t["frames"])
    # A request that takes exactly its flops at the peak: 100 %.
    run = _run(cell, flops / PEAK_BF16_FLOPS, requests=7)
    assert spec.reader(name).read(run) == pytest.approx(100.0)
    run = _run(cell, 4 * flops / PEAK_BF16_FLOPS, requests=7)
    assert spec.reader(name).read(run) == pytest.approx(25.0)


def test_idle_share_reader():
    cell = spec.cell("spa3d.tail")
    run = _run(cell, 1.0, requests=4, kernel_s=1.0, names=["k"])
    assert spec.reader("idle_share.tail").read(run) == pytest.approx(75.0)
    run.trace = None
    assert spec.reader("idle_share.tail").read(run) is None
