"""The cell ``spa3d_vdal.depth_tail`` on the CPU at tiny sizes: a whole run's last line,
the plain reference equal to the program at f32, the check failing the control and a
misplaced motion module, the refusal of a program that builds another head, and the work
counts against the reference's own products.

The tiny model keeps VDA-L's kinds (a ViT tapped at four blocks, motion modules on the
projected layers 3 and 4 at widths unequal to the head's features, 32-frame windows with
keyframes) at width 32 on a 4 x 4 patch grid; the program's ``vitl`` preset and head
widths are swapped for it."""

from __future__ import annotations

import copy
import functools
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import runner, spec, weights
from benchmark.harness.peaks import PEAK_BF16_FLOPS
from benchmark.harness.trace import Summary
from benchmark.harness.window import Window
from benchmark.reference import vda as reference_vda
from benchmark.tests import tiny
from benchmark.work import vda
from benchmark.work.model_flops import forward_flops
from benchmark.work.vit import attention_bound_s

SEED = 2 ** 31 + 77
CELL = "spa3d_vdal.depth_tail"
TINY_ENCODER = dict(preset="vitl", hidden_size=32, num_layers=4, num_heads=2, mlp_ratio=4,
                    ffn="mlp", patch_size=14, image_size=56, layer_norm_eps=1e-6,
                    layerscale_value=1.0)
TINY_HEAD = dict(features=32, out_channels=[16, 24, 64, 96], layer_idxs=[0, 1, 2, 3])
TINY_TRAFFIC = dict(videos=2, frames=40, height=48, width=48, grid=4, dino_grid=[3, 3, 8],
                    support=8, queries=4, splits=16, sample_requests=2, sample_from_first=4,
                    warmup_requests=1, reference_block_frames=5, reference_block_locations=3,
                    trace={"wait": 1, "warmup": 1, "active": 2, "repeat": 1})


def tiny_cell(f32: bool = False) -> dict:
    cell = copy.deepcopy(spec.cell(CELL))
    config = cell["config"]
    config.update({k: v for k, v in tiny.TINY_MODEL.items() if k in config})
    config["depth"].update(encoder=dict(TINY_ENCODER), input_size=56, output_bias_offset=4.0,
                           **TINY_HEAD)
    cell["traffic"].update(TINY_TRAFFIC)
    if f32:
        config.update(dtype="float32", fused_attention=False)
    return cell


@pytest.fixture
def tiny_vda(monkeypatch):
    """The program's ``vitl`` preset and its VDA head widths cut to the tiny ones;
    ``f32`` makes the estimator compute in float32."""
    from tdspa_torch.features import depth
    from tdspa_torch.features.vit import ViTConfig

    keys = [k for k in TINY_ENCODER if k != "preset"]
    monkeypatch.setitem(ViTConfig.PRESETS, "vitl", {k: TINY_ENCODER[k] for k in keys})
    monkeypatch.setitem(depth.VDA_MODEL_CONFIGS, "vitl", dict(TINY_HEAD))

    def f32():
        monkeypatch.setattr(depth, "VideoDepthEstimator",
                            functools.partial(depth.VideoDepthEstimator, dtype=torch.float32))

    return types.SimpleNamespace(f32=f32)


def _run(cell, trace=False, seconds=10.0):
    # A tiny request takes 0.3-2 s on a shared CPU: the window has to hold the first
    # ``sample_from_first`` of them for the check to compare any.
    return runner.run_cell(cell, SEED, seconds, trace, "cpu", 0.0, emit=lambda line: None)


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("trace", [False, True])
def test_depth_tail_last_line(tiny_vda, trace):
    result = _run(tiny_cell(), trace)
    names = set(result["metrics"])
    if trace:
        # The roofline and idle share read a device trace, which the CPU lacks.
        assert "mfu.depth_tail" in names and names <= {
            "mfu.depth_tail", "vit_attention_roofline.depth_tail", "idle_share.tail"}
    else:
        assert names == {"setup_s", "tail_ms"}
    assert set(result["checks"]) == {"depth_gap", "tracks_query_gap",
                                     "visible_logits_query_gap"}
    assert result["attempted"] >= TINY_TRAFFIC["sample_from_first"]


def test_depth_tail_reference_is_the_programs_at_f32(tiny_vda):
    tiny_vda.f32()
    cell = tiny_cell(f32=True)
    from benchmark.drivers import depth_tail
    from tdspa_torch.features import depth

    program = depth_tail.Cell(cell["config"], cell["traffic"], SEED, "cpu")
    assert program.depth.head.motion_widths == (64, 96, 32, 32)
    depth.depth_window.windows = depth.depth_window.frame_passes = 0
    for i in range(TINY_TRAFFIC["sample_from_first"]):
        program.request(i)
    assert (depth.depth_window.windows, depth.depth_window.frame_passes) == (8, 256)
    assert sorted(program.kept) == sorted(program.keep) and len(program.keep) == 2
    kept_depth = program.kept[min(program.kept)][0]
    assert float((kept_depth > 0).float().mean()) > 0.5
    program.release_program()
    gaps = program.readings()
    assert all(v < 1e-4 for v in gaps.values()), gaps


def test_depth_tail_check_fails_the_control_and_a_misplaced_module(tiny_vda, monkeypatch):
    tiny_vda.f32()
    from benchmark.drivers import depth_tail
    from tdspa_torch.features import depth

    assert _run(tiny_cell(f32=True))["correct"] is True
    real = depth_tail.Cell.readings
    monkeypatch.setattr(depth_tail.Cell, "readings",
                        lambda self, control=None: real(self, control="fp8"))
    assert _failed(_run(tiny_cell(f32=True)))
    monkeypatch.setattr(depth_tail.Cell, "readings", real)

    motion = depth.DPTHead._motion

    def skipped(self, idx, x):  # motion module 2 left out
        return x if idx == 2 else motion(self, idx, x)

    monkeypatch.setattr(depth.DPTHead, "_motion", skipped)
    assert "depth_gap" in _failed(_run(tiny_cell(f32=True)))


def test_depth_tail_refuses_a_program_of_another_head(tiny_vda, monkeypatch):
    """A program whose motion modules are all ``features`` wide ends the run before any
    weight is made."""
    from tdspa_torch.features import depth

    real = depth.DPTHead.__init__

    def all_features(self, in_dim, features, out_channels, **kwargs):
        real(self, in_dim, features, out_channels, **kwargs)
        self.motion_widths = (features,) * 4

    monkeypatch.setattr(depth.DPTHead, "__init__", all_features)
    monkeypatch.setattr(weights, "make", lambda *a: pytest.fail("weights made"))
    cell = tiny_cell()
    from benchmark.drivers import depth_tail

    with pytest.raises(runner.RunError, match="motion_widths"):
        depth_tail.Cell(cell["config"], cell["traffic"], SEED, "cpu")


def test_vda_flops_are_the_references_products():
    cfg = tiny_cell()["config"]["depth"]
    w = weights.make(reference_vda.param_shapes(cfg), 1, "cpu")
    frames = torch.randint(0, 256, (40, 48, 48, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        reference_vda.VDA(cfg, w, frame_block=5, location_block=3).video(frames)
    assert counter.get_total_flops() == vda.forward_flops(cfg, 40, 48, 48)


def test_vdal_work_counts():
    """The cell's video: 7 windows, 1370 tokens a frame, 1.014 TFLOP a frame pass in the
    encoder, 0.291 in the head, 3.21 a window in the motion modules, 315 a video; 168
    attention launches of (32, 1370, 1370, 16, 64), bound by flops."""
    cell = spec.cell(CELL)
    cfg, t = cell["config"]["depth"], cell["traffic"]
    assert vda.windows(t["frames"], cfg["window"], cfg["overlap"]) == 7
    assert vda.grid(cfg, t["height"], t["width"]) == (37, 37)
    assert vda.head_flops(cfg, 37, 37) == pytest.approx(0.2906e12, rel=1e-3)
    assert vda.motion_flops(cfg, 37, 37, 32) == pytest.approx(3.2147e12, rel=1e-4)
    assert vda.forward_flops(cfg, t["frames"], t["height"], t["width"]) == \
        pytest.approx(314.65e12, rel=1e-4)
    calls = vda.attention_calls(cfg, t["frames"], t["height"], t["width"])
    assert len(calls) == 168 and set(calls) == {(32, 1370, 1370, 16, 64)}
    flops = 4.0 * 32 * 16 * 1370 * 1370 * 64
    assert attention_bound_s(calls[0], out_bytes=2) == pytest.approx(flops / PEAK_BF16_FLOPS)


def _timed_run(cell, seconds_per_request, requests, kernel_s=None, names=()):
    w = Window()
    for i in range(requests):
        w.record(i * seconds_per_request, (i + 1) * seconds_per_request)
    trace = Summary()
    trace.add_cycle([(0.0, requests * seconds_per_request)],
                    [(n, 0.0, kernel_s) for n in names], [])
    return types.SimpleNamespace(config=cell["config"], traffic=cell["traffic"], window=w,
                                 trace=trace, setup_s=1.0)


def test_shares_reach_100_percent_at_the_bound_and_no_more():
    cell = spec.cell(CELL)
    cfg, t = cell["config"], cell["traffic"]
    flops = vda.forward_flops(cfg["depth"], t["frames"], t["height"], t["width"]) + \
        forward_flops(cfg, 1, t["support"], t["queries"], t["frames"])
    mfu = spec.reader("mfu.depth_tail")
    assert mfu.read(_timed_run(cell, flops / PEAK_BF16_FLOPS, 5)) == pytest.approx(100.0)
    bound = sum(attention_bound_s(c, out_bytes=2) for c in vda.attention_calls(
        cfg["depth"], t["frames"], t["height"], t["width"]))
    roofline = spec.reader("vit_attention_roofline.depth_tail")
    assert roofline.read(_timed_run(cell, 1.0, 1, bound, ["vit_attention_kernel"])) == \
        pytest.approx(100.0)
    assert roofline.read(_timed_run(cell, 1.0, 1, 1.0, ["masked_attention_kernel"])) is None
