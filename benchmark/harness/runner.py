"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

``run_cell`` takes the device it is given; ``benchmark/run.py`` gives it the
card only after making sure there is one, and tests give it the CPU with
tiny cells.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
import types

from benchmark.harness import spec, window as window_mod
from benchmark.harness.trace import REQUEST_SPAN, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "tdspa")


class RunError(RuntimeError):
    """A run that must end without a result."""


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the process must not hold,
    each compared whole (``tdspa_torch`` is not ``tdspa``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def launch_counts() -> dict[str, int]:
    """The program's own launch counters of its kernel wrappers."""
    from tdspa_torch.kernels import attention, bilinear

    return {"fused_masked_attention": attention.fused_masked_attention.launches,
            "attention_backward": attention.attention_backward.launches,
            "vit_attention": attention.vit_attention.launches,
            "bilinear_sample": bilinear.bilinear_sample.launches}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _warm_profiler(device) -> None:
    """Start the device tracer once in set-up, so its first start is not
    inside the window."""
    import torch
    import torch.profiler as tp

    with tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             emit=print) -> dict:
    """Runs the cell and returns its result (the last line's object).
    ``t0`` is the process's start on ``time.perf_counter``'s clock."""
    import torch

    name = cell["workload"]["name"]
    started = time.perf_counter() - t0
    driver = importlib.import_module(cell["driver"])
    device = torch.device(device)
    on_card = device.type == "cuda"
    program = driver.Cell(cell["config"], cell["traffic"], seed, device)
    if trace:
        _warm_profiler(device)
    before = launch_counts()
    tracer = Tracer(**cell["traffic"]["trace"]) if trace else None
    if tracer is None:
        setup_s = time.perf_counter() - t0
        window = window_mod.run(program.request, seconds)
    else:
        from torch.profiler import record_function

        def request(i):
            with record_function(REQUEST_SPAN):
                program.request(i)

        setup_s = time.perf_counter() - t0
        with tracer:
            window = window_mod.run(request, seconds, after=tracer.step)
    found = forbidden_modules()
    if found:
        raise RunError(f"the process holds {found} after the window")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    after = launch_counts()
    emit(json.dumps({"bench": "setup", "before_cell_s": started, **program.setup.parts}))
    emit(json.dumps({"bench": "launches_per_request", "workload": name,
                     **{k: (after[k] - before[k]) / window.count for k in after}}))
    emit(json.dumps({"bench": "weights", "made": "from the seed on the device",
                     "card": card_line() if on_card else "cpu"}))
    if tracer is not None:
        emit(json.dumps({"bench": "trace", "requests": tracer.summary.requests}))

    program.release_program()
    readings = program.readings()
    limits = cell["limits"]["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    run = types.SimpleNamespace(config=cell["config"], traffic=cell["traffic"], workload=name,
                                window=window, setup_s=setup_s,
                                trace=None if tracer is None else tracer.summary)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for metric in wanted:
        value = spec.reader(metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.count, "failed": 0, "metrics": metrics,
              "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.summary.busy_s
        dev["window_s"] = tracer.summary.window_s
        result["breakdown"] = tracer.summary.breakdown()
    result["checks"] = checks
    return result


def _finite(value):
    """JSON holds no NaN or infinity: such a reading is written as a string."""
    return value if math.isfinite(value) else str(value)


def print_result(result: dict) -> None:
    for check in result["checks"].values():
        check["value"] = _finite(check["value"])
    for key, check in result["checks"].items():
        print(f"check {key} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
