"""The port stands alone: tdspa_torch and chip_smoke.py import neither JAX nor
any module of the JAX package, nor triton at import time, and the GPU entry
points refuse to run on a host without a GPU instead of falling back."""

import json
from pathlib import Path
import shutil
import subprocess
import sys

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "triton"):
    sys.modules[name] = None  # any import of these now raises ImportError
import tdspa_torch
modules = [m.name for m in pkgutil.walk_packages(tdspa_torch.__path__, "tdspa_torch.")]
for name in modules:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m == "tdspa" or m.startswith("tdspa."))
print(json.dumps({"modules": modules, "tdspa_loaded": loaded}))
"""


def _run(code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_port_imports_without_jax_tdspa_or_triton():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["tdspa_loaded"] == []
    for name in ("tdspa_torch.kernels.attention", "tdspa_torch.infer.pipeline",
                 "tdspa_torch.models.spa3d", "tdspa_torch.utils.jax_prng",
                 "tdspa_torch.kernels.lk", "tdspa_torch.kernels.matcher", "tdspa_torch.ops.lk",
                 "tdspa_torch.ops.filters", "tdspa_torch.ops.warp", "tdspa_torch.ops.yuv",
                 "tdspa_torch.features.matcher", "tdspa_torch.features.tracks",
                 "tdspa_torch.utils.synthetic_video", "tdspa_torch.eval.tracking_quality",
                 "tdspa_torch.features.vit", "tdspa_torch.features.dino",
                 "tdspa_torch.features.depth", "tdspa_torch.core.layers",
                 "tdspa_torch.ops.resize", "tdspa_torch.core.quant",
                 "tdspa_torch.kernels.quant_matmul", "tdspa_torch.kernels.block",
                 "tdspa_torch.kernels.bilinear", "tdspa_torch.infer.video",
                 "tdspa_torch.utils.profiling", "tdspa_torch.cli.flags", "tdspa_torch.cli.infer",
                 "tdspa_torch.cli.evaluate", "tdspa_torch.eval.tapvid3d_metrics",
                 "tdspa_torch.eval.realism", "tdspa_torch.eval.harness",
                 "tdspa_torch.data.providers"):
        assert name in report["modules"]


def test_matcher_weights_are_a_byte_identical_copy():
    ported = (REPO / "tdspa_torch" / "assets" / "matcher_default.npz").read_bytes()
    assert ported == (REPO / "tdspa" / "assets" / "matcher_default.npz").read_bytes()


def test_port_sources_name_no_jax_package():
    for path in [*sorted((REPO / "tdspa_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "flax", "tdspa", "triton"), (
                    f"{path}: {line}"
                )


def test_gpu_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    for code in ("from tdspa_torch.infer.pipeline import InferencePipeline\nInferencePipeline()\n",
                 "from tdspa_torch.features.tracks import PyramidalLKTracker\n"
                 "PyramidalLKTracker()\n",
                 "from tdspa_torch.features.dino import DinoFeatureExtractor\n"
                 "DinoFeatureExtractor()\n",
                 "from tdspa_torch.features.depth import VideoDepthEstimator\n"
                 "VideoDepthEstimator()\n"):
        proc = _run(code)
        assert proc.returncode != 0
        assert "no CUDA GPU" in proc.stderr and "device='cpu'" in proc.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
