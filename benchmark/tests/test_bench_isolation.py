"""What the benchmark's process holds: nothing of JAX, flax or the JAX
package (``tdspa``) in a run, nothing of the program (``tdspa_torch``) in
the plain reference; each module compared by its whole top-level name."""

import json
from pathlib import Path
import shutil
import subprocess
import sys

from benchmark.harness import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "tdspa"}

RUN = """
import sys, json
sys.path.insert(0, {root!r})
from benchmark.harness import runner
from benchmark.tests import tiny
runner.run_cell(tiny.cell({workload!r}), 7, 0.2, False, "cpu", 0.0, emit=lambda line: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import torch
from benchmark.harness import generate, weights
from benchmark.reference import model, precision, prng, tail, train
from benchmark.tests import tiny
cell = tiny.cell("trajan2d.train")
cfg, t = cell["config"], cell["traffic"]
w = weights.make(model.param_shapes(cfg), 3, "cpu")
batch = generate.orbit_batch(t, 2, 2, torch.Generator().manual_seed(3), "cpu")
train.run_steps(cfg, w, [batch])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_holds_no_jax_and_no_jax_package():
    for workload in ("spa3d.tail", "trajan2d.train"):
        held = _modules(RUN.format(root=str(ROOT), workload=workload))
        assert "tdspa_torch" in held  # the program ran
        assert not held & FORBIDDEN, held & FORBIDDEN


def test_the_reference_holds_nothing_of_the_program():
    held = _modules(REFERENCE.format(root=str(ROOT)))
    assert not held & (FORBIDDEN | {"tdspa_torch"})


def test_runner_compares_whole_top_level_names(monkeypatch):
    from benchmark.harness import runner

    monkeypatch.setitem(sys.modules, "tdspa_torch_extra", sys)
    assert runner.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0]
                                                             for m in sys.modules})
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in runner.forbidden_modules()


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "spa3d.tail",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_with_only_the_benchmarks_files_the_command_fails(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "spa3d.tail",
                          "--seed", "11", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert not (Path(tmp_path) / "tdspa_torch").exists()
