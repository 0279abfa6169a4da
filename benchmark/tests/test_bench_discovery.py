"""A later cell, configuration, traffic mix or metric is found by its name
alone: added files and entries, no edit of an existing file."""

import json
import shutil

import pytest

from benchmark.harness import spec


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_every_cell_of_the_benchmark_is_found():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["architecture"]
        assert cell["limits"]["limits"]
        names = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec.reader(m["name"]).read)
        assert __import__(cell["driver"], fromlist=["Cell"]).Cell


def test_new_config_traffic_workload_and_metric_by_files_alone(tmp_path):
    root = _copy(tmp_path)
    bench_dir = root / "benchmark"
    config = json.loads((bench_dir / "configs" / "spa3d.json").read_text())
    config["fused_block"] = True
    (bench_dir / "configs" / "spa3d_fused_block.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "tail.json").read_text())
    traffic["queries"] = 256
    (bench_dir / "traffic" / "tail_small.json").write_text(json.dumps(traffic))
    (bench_dir / "limits" / "spa3d_fused_block.tail_small.json").write_text(
        json.dumps({"limits": {"tracks_query_gap": 0.5}}))
    (bench_dir / "metrics" / "block_roofline.tail_small.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "spa3d_fused_block", "source": "x",
                             "file": "benchmark/configs/spa3d_fused_block.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "spa3d_fused_block.tail_small",
                               "config": "spa3d_fused_block", "traffic": "tail_small",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "block_roofline.tail_small", "unit": "%",
                               "better": "higher", "source": "device_trace", "layer": "kernels",
                               "moves": "tail_ms",
                               "workloads": ["spa3d_fused_block.tail_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("spa3d_fused_block.tail_small", root=root, bench_dir=bench_dir)
    assert cell["config"]["fused_block"] is True
    assert cell["traffic"]["queries"] == 256
    assert cell["driver"] == "benchmark.drivers.tail"
    assert [m["name"] for m in cell["per_layer"]] == ["block_roofline.tail_small"]
    # Metrics with no workloads list reach every cell; listed ones only theirs.
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]
    assert spec.reader("block_roofline.tail_small", bench_dir=bench_dir).read(None) == 42.0
    old = spec.cell("spa3d.tail", root=root, bench_dir=bench_dir)
    assert "block_roofline.tail_small" not in [m["name"] for m in old["per_layer"]]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such.cell")
