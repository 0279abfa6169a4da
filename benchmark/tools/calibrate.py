#!/usr/bin/env python3
"""Readings from which a cell's limits are set: the program's numbers over
many seeds, the control's (the plain reference with fp8 products, the step
below the configurations' bf16, in the program's place) over a few, and,
for training, the planted faults' that need a run. One process, on the card:

    python3 benchmark/tools/calibrate.py --workload spa3d.tail \\
        --seeds 11,12,13 --control_seeds 21,22,23 --seconds 8

For each seed the cell is set up as a run sets it up; a serving cell then
serves for ``--seconds`` at its own load so that its sample fills, a training
cell has its checked steps from set-up. Prints one JSON line per reading
(for training also each step's loss gap and the worst leaves) and a summary
last: the largest program reading and the smallest control and fault
readings of each number.
"""

import argparse
import importlib
import json
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

DEVICE = "cuda:0"


def _worst(got: dict, want: dict, top: int = 3) -> list:
    ordered = sorted(want.values())
    median = ordered[len(ordered) // 2]
    gaps = {k: abs(got[k] - v) / max(v, median) for k, v in want.items()}
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)

    import torch

    from benchmark.drivers.common import reference_mode, sync
    from benchmark.harness import spec, window

    cell = spec.cell(args.workload)
    driver = importlib.import_module(cell["driver"])
    training = cell["traffic"]["entry"] == "train"
    summary: dict = {"program": {}, "control": {}, "faults": {}}

    def note(kind, seed, readings, **extra):
        print(json.dumps({"kind": kind, "seed": seed, **readings, **extra}), flush=True)
        for name, value in readings.items():
            summary[kind].setdefault(name, []).append(value)

    def set_up(seed):
        program = driver.Cell(cell["config"], cell["traffic"], seed, DEVICE)
        if not training:
            w = window.run(program.request, args.seconds)
            print(json.dumps({"kind": "window", "seed": seed, "requests": w.count,
                              "ms": w.mean_s() * 1e3}), flush=True)
        program.release_program()
        return program

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        program = set_up(seed)
        if training:
            reference_mode(True)
            want, got = program.reference(), program.program()
            reference_mode(False)
            note("program", seed, program.gaps(got, want),
                 loss_rel_per_step=[abs(a - b) / abs(b)
                                    for a, b in zip(got["losses"], want["losses"])],
                 worst_first_grad=_worst(got["first_grad"], want["first_grad"]),
                 worst_change=_worst(got["change"], want["change"]))
        else:
            note("program", seed, program.readings())
        del program
        sync(DEVICE, empty_cache=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        program = set_up(seed)
        if training:
            reference_mode(True)
            want = program.reference()
            got = program.reference("fp8")
            note("control", seed, program.gaps(got, want),
                 loss_rel_per_step=[abs(a - b) / abs(b)
                                    for a, b in zip(got["losses"], want["losses"])])
            for fault in ("half_batch", "grad_doubled"):
                note("faults", seed, {f"{fault}.{k}": v for k, v in program.gaps(
                    program.reference(fault=fault), want).items()})
            reference_mode(False)
        else:
            note("control", seed, program.readings(control="fp8"))
        del program
        sync(DEVICE, empty_cache=True)
    print(json.dumps({"summary": {
        "program_max": {k: max(v) for k, v in summary["program"].items()},
        "control_min": {k: min(v) for k, v in summary["control"].items()},
        "faults_min": {k: min(v) for k, v in summary["faults"].items()},
        "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
