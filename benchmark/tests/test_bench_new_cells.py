"""The cells ``spa3d_dinov2g.features_tail`` and ``spa3d.train`` on the CPU at
tiny sizes: a whole run's last line, the plain references equal to the
program at f32, the check failing the control and planted faults, the
refusal of a program that builds another backbone, and the work counts.

The tiny backbone keeps ViT-g/14's kinds (SwiGLU, CLS, a position table
resized from a 3x3 native grid to the frames' 2x2) at width 48; the
program's configuration of the model name is swapped for it."""

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
from benchmark.reference import dinov2 as reference_dinov2
from benchmark.tests import tiny
from benchmark.work import vit
from benchmark.work.attention import backward_bound_s, forward_calls
from benchmark.work.model_flops import forward_flops

SEED = 2 ** 31 + 55
FEATURES = "spa3d_dinov2g.features_tail"
TRAIN = "spa3d.train"
TINY_BACKBONE = dict(model_name="facebook/dinov2-giant", hidden_size=48, num_layers=2,
                     num_heads=3, mlp_ratio=4, ffn="swiglu", patch_size=14, image_size=42,
                     layer_norm_eps=1e-6, layerscale_value=1.0)
TINY_FEATURES = dict(videos=2, frames=12, height=32, width=32, upload_chunk_frames=5, grid=4,
                     support=8, queries=4, splits=16, sample_requests=2, sample_from_first=4,
                     warmup_requests=1, reference_block_frames=5,
                     trace={"wait": 1, "warmup": 1, "active": 2, "repeat": 1})
TINY_TRAIN = dict(tracks=16, support=8, queries=8, frames=12, batches=3, checked_steps=3,
                  trace={"wait": 1, "warmup": 1, "active": 1, "repeat": 1})


def tiny_cell(workload: str, f32: bool = False) -> dict:
    cell = copy.deepcopy(spec.cell(workload))
    config = cell["config"]
    config.update({k: v for k, v in tiny.TINY_MODEL.items() if k in config})
    if workload == FEATURES:
        config.update(dino_feature_dim=TINY_BACKBONE["hidden_size"], backbone=dict(TINY_BACKBONE))
        cell["traffic"].update(TINY_FEATURES)
    else:
        cell["traffic"].update(TINY_TRAIN)
        cell["traffic"]["job"].update(batch_size=2, encoder_scan_chunk_size=4,
                                      decoder_scan_chunk_size=4)
    if f32:
        config.update(dtype="float32", fused_attention=False)
    return cell


@pytest.fixture
def tiny_backbone(monkeypatch):
    """The program's ViT-g/14 cut to ``TINY_BACKBONE``; ``f32`` makes its
    extractor compute in float32."""
    from tdspa_torch.features import dino
    from tdspa_torch.features.vit import ViTConfig

    keys = [k for k in TINY_BACKBONE if k != "model_name"]
    monkeypatch.setattr(dino, "dino_config", lambda name: ViTConfig(
        **{k: TINY_BACKBONE[k] for k in keys}, pos_resize="hf"))

    def f32():
        monkeypatch.setattr(dino, "DinoFeatureExtractor",
                            functools.partial(dino.DinoFeatureExtractor, dtype=torch.float32))

    return types.SimpleNamespace(f32=f32)


def _run(cell, trace=False, seconds=0.3):
    return runner.run_cell(cell, SEED, seconds, trace, "cpu", 0.0, emit=lambda line: None)


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("trace", [False, True])
def test_features_tail_last_line(tiny_backbone, trace):
    # A tiny request takes 0.1-0.5 s on a shared CPU: the window has to hold
    # the first ``sample_from_first`` of them for the check to compare any.
    result = _run(tiny_cell(FEATURES), trace, seconds=3.0)
    names = set(result["metrics"])
    if trace:
        # The roofline and idle share read a device trace, which the CPU lacks.
        assert "mfu.features_tail" in names and names <= {
            "mfu.features_tail", "vit_attention_roofline.features_tail",
            "idle_share.features_tail"}
    else:
        assert names == {"setup_s", "tail_ms"}
    assert set(result["checks"]) == {"dino_token_gap", "tracks_query_gap",
                                     "visible_logits_query_gap"}
    assert result["attempted"] >= TINY_FEATURES["sample_from_first"]


def test_features_tail_reference_is_the_programs_at_f32(tiny_backbone):
    tiny_backbone.f32()
    cell = tiny_cell(FEATURES, f32=True)
    from benchmark.drivers import features_tail

    program = features_tail.Cell(cell["config"], cell["traffic"], SEED, "cpu")
    for i in range(TINY_FEATURES["sample_from_first"]):
        program.request(i)
    assert sorted(program.kept) == sorted(program.keep) and len(program.keep) == 2
    program.release_program()
    gaps = program.readings()
    assert all(v < 1e-4 for v in gaps.values()), gaps


def test_features_tail_check_fails_the_control_and_faults(tiny_backbone, monkeypatch):
    tiny_backbone.f32()
    from benchmark.drivers import features_tail
    from tdspa_torch.features import vit as vit_lib

    assert _run(tiny_cell(FEATURES, f32=True))["correct"] is True
    real = features_tail.Cell.readings
    monkeypatch.setattr(features_tail.Cell, "readings",
                        lambda self, control=None: real(self, control="fp8"))
    assert _failed(_run(tiny_cell(FEATURES, f32=True)))
    monkeypatch.setattr(features_tail.Cell, "readings", real)

    def gate_swapped(self, x):  # silu on the other half
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(torch.nn.functional.silu(x2) * x1)

    monkeypatch.setattr(vit_lib._Block, "ffn", gate_swapped)
    failed = _failed(_run(tiny_cell(FEATURES, f32=True)))
    assert "dino_token_gap" in failed


def test_features_tail_refuses_a_program_of_another_backbone(monkeypatch):
    """A program whose giant is the GELU MLP (the parent's) ends the run
    before any weight is made."""
    from tdspa_torch.features import dino
    from tdspa_torch.features.vit import ViTConfig

    monkeypatch.setattr(dino, "dino_config", lambda name: ViTConfig.preset("vitg", ffn="mlp"))
    monkeypatch.setattr(weights, "make", lambda *a: pytest.fail("weights made"))
    cell = spec.cell(FEATURES)
    from benchmark.drivers import features_tail

    with pytest.raises(runner.RunError, match="ffn"):
        features_tail.Cell(cell["config"], cell["traffic"], SEED, "cpu")


def test_vit_flops_are_the_references_products():
    cfg = TINY_BACKBONE
    w = weights.make(reference_dinov2.param_shapes(cfg), 1, "cpu")
    frames = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        reference_dinov2.Backbone(cfg, w).patch_grid(frames, 2)
    assert counter.get_total_flops() == vit.forward_flops(cfg, 3, 32, 32)


def test_giant_work_counts():
    """The cell's video: 1297 tokens a frame, 3.35 TFLOP a frame, 760
    attention launches of (8, 1297, 1297, 24, 64) bound by flops at 83.6 us."""
    cell = spec.cell(FEATURES)
    backbone, t = cell["config"]["backbone"], cell["traffic"]
    assert vit.ffn_width(backbone) == 4096
    assert vit.forward_flops(backbone, 1, 504, 504) == pytest.approx(3.3534e12, rel=1e-4)
    calls = vit.attention_calls(backbone, t["frames"], t["height"], t["width"],
                                t["upload_chunk_frames"])
    assert len(calls) == 760 and set(calls) == {(8, 1297, 1297, 24, 64)}
    assert vit.attention_bound_s(calls[0]) * 1e6 == pytest.approx(83.6, abs=0.05)


def _timed_run(cell, seconds_per_request, requests, kernel_s=None, names=()):
    w = Window()
    for i in range(requests):
        w.record(i * seconds_per_request, (i + 1) * seconds_per_request)
    trace = Summary()
    trace.add_cycle([(0.0, requests * seconds_per_request)],
                    [(n, 0.0, kernel_s) for n in names], [])
    return types.SimpleNamespace(config=cell["config"], traffic=cell["traffic"], window=w,
                                 trace=trace, setup_s=1.0)


def test_new_shares_reach_100_percent_at_the_bound_and_no_more():
    cell = spec.cell(FEATURES)
    cfg, t = cell["config"], cell["traffic"]
    flops = vit.forward_flops(cfg["backbone"], t["frames"], t["height"], t["width"]) + \
        forward_flops(cfg, 1, t["support"], t["queries"], t["frames"])
    mfu = spec.reader("mfu.features_tail")
    assert mfu.read(_timed_run(cell, flops / PEAK_BF16_FLOPS, 5)) == pytest.approx(100.0)
    bound = sum(map(vit.attention_bound_s, vit.attention_calls(
        cfg["backbone"], t["frames"], t["height"], t["width"], t["upload_chunk_frames"])))
    roofline = spec.reader("vit_attention_roofline.features_tail")
    assert roofline.read(_timed_run(cell, 1.0, 1, bound, ["vit_attention_kernel"])) == \
        pytest.approx(100.0)
    assert roofline.read(_timed_run(cell, 1.0, 1, 2 * bound, ["vit_attention_kernel"])) == \
        pytest.approx(50.0)
    # The tail's masked attention is not the ViT's.
    assert roofline.read(_timed_run(cell, 1.0, 1, 1.0, ["masked_attention_kernel"])) is None

    cell = spec.cell(TRAIN)
    cfg, t = cell["config"], cell["traffic"]
    batch = t["job"]["batch_size"]
    flops = 3 * forward_flops(cfg, batch, t["support"], t["queries"], t["frames"])
    assert spec.reader("mfu.train3d").read(_timed_run(cell, flops / PEAK_BF16_FLOPS, 3)) == \
        pytest.approx(100.0)
    bound = sum(map(backward_bound_s, forward_calls(cfg, batch, t["support"], t["queries"],
                                                    t["frames"])))
    reader = spec.reader("attention_backward_roofline.train3d")
    assert reader.read(_timed_run(cell, 1.0, 1, bound, ["attention_backward_kernel"])) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("trace", [False, True])
def test_train3d_last_line(trace):
    result = _run(tiny_cell(TRAIN), trace)
    names = set(result["metrics"])
    if trace:
        assert "mfu.train3d" in names and names <= {
            "mfu.train3d", "attention_backward_roofline.train3d", "idle_share.train"}
    else:
        assert names == {"setup_s", "train_step_ms"}
    assert set(result["checks"]) == {"first_grad_leaf", "change_leaf", "change_median"}


def test_train3d_reference_is_the_programs_at_f32():
    from benchmark.drivers import train3d

    cell = tiny_cell(TRAIN, f32=True)
    program = train3d.Cell(cell["config"], cell["traffic"], SEED, "cpu")
    batch = program.batches[0]
    assert batch["dino_features"].shape == (2, 8, 12, tiny.TINY_MODEL["dino_feature_dim"])
    assert batch["depth_features"].shape == (2, 8, 12, 256)
    program.release_program()
    gaps = program.readings()
    assert all(v < 1e-3 for v in gaps.values()), gaps


def test_train3d_check_fails_a_gradient_altered(monkeypatch):
    from tdspa_torch.train import step

    assert _run(tiny_cell(TRAIN, f32=True))["correct"] is True
    real = step.loss_and_grads

    def altered(*args, **kwargs):  # the largest leaf's gradient doubled
        losses, grads = real(*args, **kwargs)
        big = max(range(len(grads)), key=lambda i: grads[i].numel())
        grads[big] = grads[big] * 2
        return losses, grads

    monkeypatch.setattr(step, "loss_and_grads", altered)
    assert "first_grad_leaf" in _failed(_run(tiny_cell(TRAIN, f32=True)))
