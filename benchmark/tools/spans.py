#!/usr/bin/env python3
"""Device time of the program's layers in one cell, read from its spans, and
what the spans cost. One process, on the card:

    python3 benchmark/tools/spans.py --workload spa3d.tail --seed 7 --seconds 51 --rounds 2

The cell is set up as a run sets it up. Then, ``--rounds`` times, three
windows of ``--seconds`` each on the same program: traced as ``run.py
--trace 1`` traces (the traffic file's schedule) with the spans on; traced
with the spans off (the profiler records, the spans do not); untraced.
Each prints one JSON line: the mean latency of the requests the profiler
recorded (``traced_request_ms``) and of every request (``request_ms``);
for a traced window also the idle share, the breakdown, and the spans'
reduction (``harness/spans.py``): per traced request each span's calls,
host ms and device ms, the share of busy time the spans hold, idle ms under
the innermost open span, and the per-layer readings below. No check against
the reference is made.
"""

import argparse
import json
from pathlib import Path
import statistics
import sys
import time

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

DEVICE = "cuda:0"
# Per-layer readings, device ms per traced request: the spans summed; each
# in the cells of its suffix's traffic.
READINGS = {
    "prep_device_ms.tail": ("tdspa.tail.lift", "tdspa.tail.sample", "tdspa.tail.split"),
    "encoder_device_ms.tail": ("tdspa.model.encode_tracks",),
    "latents_device_ms.tail": ("tdspa.model.latents",),
    "decoder_device_ms.tail": ("tdspa.model.decode",),
    "forward_device_ms.train": ("tdspa.train.forward",),
    "backward_device_ms.train": ("tdspa.train.backward",),
    "optimizer_device_ms.train": ("tdspa.train.optimizer",),
}
# A whole and the parts that should add up to it.
WHOLES = {"tdspa.tail": ("tdspa.tail.lift", "tdspa.tail.sample", "tdspa.tail.split",
                         "tdspa.model.encode_tracks", "tdspa.model.latents",
                         "tdspa.model.decode"),
          "tdspa.train.step": ("tdspa.train.forward", "tdspa.train.backward",
                               "tdspa.train.optimizer")}


def traced_indices(trace: dict) -> list[int]:
    """Requests the profiler records under ``torch.profiler.schedule``."""
    cycle = trace["wait"] + trace["warmup"] + trace["active"]
    return [i for i in range(trace["repeat"] * cycle) if i % cycle >= cycle - trace["active"]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)

    import importlib

    import torch
    from torch.profiler import record_function

    from benchmark.harness import runner, spec, window
    from benchmark.harness.spans import SpanTracer
    from benchmark.harness.trace import REQUEST_SPAN
    from tdspa_torch.utils import profiling

    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 1
    cell = spec.cell(args.workload)
    trace = cell["traffic"]["trace"]
    suffix = "." + cell["workload"]["traffic"]
    program = importlib.import_module(cell["driver"]).Cell(
        cell["config"], cell["traffic"], args.seed, torch.device(DEVICE))
    runner._warm_profiler(torch.device(DEVICE))
    print(json.dumps({"tool": "spans", "workload": args.workload, "seed": args.seed,
                      "card": runner.card_line(), "setup_s": time.perf_counter() - T0}),
          flush=True)

    def request(i):
        with record_function(REQUEST_SPAN):
            program.request(i)

    def measured(kind: str, spans_on: bool, rnd: int) -> dict:
        profiling.record_function = record_function if spans_on else (
            lambda name: profiling._NO_SPAN)
        try:
            if kind == "untraced":
                w = window.run(program.request, args.seconds)
                tracer = None
            else:
                tracer = SpanTracer(**trace)
                with tracer:
                    w = window.run(request, args.seconds, after=tracer.step)
        finally:
            profiling.record_function = record_function
        row = {"tool": "spans", "round": rnd, "window": kind, "spans_on": spans_on,
               "window_requests": w.count, "request_ms": 1e3 * w.mean_s()}
        if tracer is not None:
            lat = w.latencies
            row["traced_request_ms"] = 1e3 * statistics.fmean(
                lat[i] for i in traced_indices(trace) if i < len(lat))
            s = tracer.summary
            row.update(idle_share=100.0 * s.idle_share, breakdown=s.breakdown(), **s.line())
            row["readings"] = {name: s.device_ms(spans) for name, spans in READINGS.items()
                               if name.endswith(suffix) and s.device_ms(spans) is not None}
            row["parts_over_whole"] = {
                whole: sum(s.device_ms([p]) or 0.0 for p in parts) / s.device_ms([whole])
                for whole, parts in WHOLES.items() if s.device_ms([whole])}
        print(json.dumps(row), flush=True)
        return row

    for rnd in range(args.rounds):
        order = [("traced", True), ("traced", False)]
        for kind, on in (order if rnd % 2 == 0 else order[::-1]) + [("untraced", True)]:
            measured(kind, on, rnd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
