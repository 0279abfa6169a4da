"""The plain reference: blocks change nothing, and at f32 it computes what
the program computes (the program's CPU path, a tiny size)."""

import torch

from benchmark.drivers import tail, train
from benchmark.harness import generate, weights
from benchmark.reference import train as reference_train
from benchmark.reference.model import Model, loss, param_shapes
from benchmark.reference.precision import Precision
from benchmark.tests import tiny


def _f32(workload):
    cell = tiny.cell(workload)
    cell["config"].update(dtype="float32", fused_attention=False)
    return cell


def test_blocks_change_neither_outputs_nor_gradients():
    cell = tiny.cell("trajan2d.train")
    cfg, t = cell["config"], cell["traffic"]
    w = {k: v.requires_grad_(True) for k, v in weights.make(param_shapes(cfg), 5, "cpu").items()}
    batch = generate.orbit_batch(t, 2, 2, torch.Generator().manual_seed(5), "cpu")
    whole = Model(cfg, w)
    blocks = Model(cfg, w, chunk=3)  # blocks of 3 of the 8 tracks and queries
    out_whole, out_blocks = whole(batch), blocks(batch)
    for k in out_whole:
        torch.testing.assert_close(out_blocks[k], out_whole[k], rtol=1e-5, atol=1e-5)
    g_whole = torch.autograd.grad(loss(cfg, out_whole, batch), list(w.values()))
    g_blocks = torch.autograd.grad(loss(cfg, out_blocks, batch), list(w.values()))
    for a, b in zip(g_blocks, g_whole):  # sums in another order: f32 rounding of the leaf
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_reference_tail_is_the_programs_at_f32():
    cell = _f32("spa3d.tail")
    program = tail.Cell(cell["config"], cell["traffic"], 9, "cpu")
    for i in range(8):
        program.request(i)
    program.release_program()
    gaps = program.readings()
    assert all(v < 1e-4 for v in gaps.values()), gaps


def test_reference_train_steps_are_the_programs_at_f32():
    cell = _f32("trajan2d.train")
    program = train.Cell(cell["config"], cell["traffic"], 9, "cpu")
    program.release_program()
    gaps = program.readings()
    assert all(v < 1e-3 for v in gaps.values()), gaps


def test_fp8_products_move_the_result():
    cell = tiny.cell("trajan2d.train")
    cfg, t = cell["config"], cell["traffic"]
    w = weights.make(param_shapes(cfg), 5, "cpu")
    batch = generate.orbit_batch(t, 2, 2, torch.Generator().manual_seed(5), "cpu")
    want = reference_train.run_steps(cfg, w, [batch])
    got = reference_train.run_steps(cfg, w, [batch], {"precision": Precision("fp8")})
    assert got["losses"][0] != want["losses"][0]
