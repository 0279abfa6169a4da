"""Everything of one cell, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:
* the configuration's file is the one its entry in ``configs`` names;
* the traffic mix is ``benchmark/traffic/<traffic>.json``; its ``entry``
  names the module that drives the program, ``benchmark.drivers.<entry>``;
* the limits of the check that decides ``correct`` are
  ``benchmark/limits/<workload>.json``;
* each metric is read by ``benchmark/metrics/<metric name>.py``.

The metrics of a cell are those whose ``workloads`` list names it, or that
have no such list. So a later cell, configuration or metric is added by
adding files and entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path):
    """A module from its file; names may hold dots (``mfu.tail.py``)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> dict:
    """{workload, config, traffic, limits, end_to_end, per_layer} of a cell;
    ``KeyError`` for a name ``BENCHMARK.json`` does not hold."""
    spec = load_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config_entry = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return {
        "workload": entry,
        "config": load_json(root / config_entry["file"]),
        "traffic": traffic,
        "limits": load_json(bench_dir / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in spec["per_layer"] if applies(m, workload)],
        "driver": f"benchmark.drivers.{traffic['entry']}",
    }


def reader(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py")
