"""The check that decides ``correct`` fails what it must: the control (the
plain reference a precision below the configuration's, in the program's
place) and each fault a cell can have, planted under the timed path of a
whole run of a tiny cell on the CPU (the run's look for a card skipped).

The program computes in f32 here, so that at a tiny size a gap is the
fault's alone; bf16's own gap at full size is what the limits were set
from (``benchmark/limits/``)."""

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests import tiny

SEED = 2 ** 31 + 77


def _run(workload):
    cell = tiny.cell(workload)
    cell["config"].update(dtype="float32", fused_attention=False)
    return runner.run_cell(cell, SEED, 0.3, False, "cpu", 0.0, emit=lambda line: None)


def _failed(result) -> list[str]:
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("workload", ["spa3d.tail", "trajan2d.train"])
def test_the_control_fails(workload, monkeypatch):
    from benchmark.drivers import tail, train

    for module in (tail, train):
        real = module.Cell.readings
        monkeypatch.setattr(module.Cell, "readings",
                            lambda self, control=None, real=real: real(self, control="fp8"))
    result = _run(workload)
    assert result["correct"] is False and _failed(result)


def test_tail_answer_altered(monkeypatch):
    import tdspa_torch.infer.pipeline as pipeline

    real = pipeline.fused_tail

    def swapped(*args, **kwargs):  # two queries' predictions trade places
        preds, batch, tracks_3d = real(*args, **kwargs)
        for x in (preds.tracks, preds.visible_logits):
            x[:, [0, 1]] = x[:, [1, 0]].clone()
        return preds, batch, tracks_3d

    monkeypatch.setattr(pipeline, "fused_tail", swapped)
    result = _run("spa3d.tail")
    assert result["correct"] is False and _failed(result)


def test_train_state_left_unchanged(monkeypatch):
    from tdspa_torch.train import state

    monkeypatch.setattr(state.Optimizer, "update",
                        lambda self, grads, opt_state, params: opt_state)
    result = _run("trajan2d.train")
    assert result["correct"] is False and "change_leaf" in _failed(result)


def test_train_schedule_doubled(monkeypatch):
    from tdspa_torch.train import state

    real = state.create_learning_rate_schedule

    def doubled(*args):
        schedule = real(*args)
        return lambda step: 2 * schedule(step)

    monkeypatch.setattr(state, "create_learning_rate_schedule", doubled)
    result = _run("trajan2d.train")
    assert result["correct"] is False and "change_leaf" in _failed(result)


def test_train_half_the_batch_left_out(monkeypatch):
    from tdspa_torch.train import step

    real = step.loss_and_grads

    def half(model, params, batch, mesh=None, visible_mass=None):
        n = next(iter(batch.values())).shape[0] // 2
        return real(model, params, {k: v[:n] for k, v in batch.items()}, mesh, visible_mass)

    monkeypatch.setattr(step, "loss_and_grads", half)
    result = _run("trajan2d.train")
    assert result["correct"] is False and _failed(result)


def test_train_gradient_altered_where_it_is_produced(monkeypatch):
    from tdspa_torch.train import step

    real = step.loss_and_grads

    def altered(*args, **kwargs):  # the largest leaf's gradient doubled
        losses, grads = real(*args, **kwargs)
        big = max(range(len(grads)), key=lambda i: grads[i].numel())
        grads[big] = grads[big] * 2
        return losses, grads

    monkeypatch.setattr(step, "loss_and_grads", altered)
    result = _run("trajan2d.train")
    assert result["correct"] is False and "first_grad_leaf" in _failed(result)


@pytest.mark.parametrize("workload", ["spa3d.tail", "trajan2d.train"])
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"] is True, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["spa3d.tail", "trajan2d.train"])
def test_the_control_fails_on_the_card_at_the_cells_size(workload, card):
    from benchmark.harness import spec
    import importlib

    cell = spec.cell(workload)
    program = importlib.import_module(cell["driver"]).Cell(cell["config"], cell["traffic"],
                                                            SEED, card)
    for i in range(cell["traffic"].get("keep_every", 1) * 4):
        if cell["traffic"]["entry"] == "train":
            break
        program.request(i)
    program.release_program()
    readings = program.readings(control="fp8")
    limits = cell["limits"]["limits"]
    assert any(not readings[k] <= limits[k] for k in limits), readings
    torch.cuda.empty_cache()
