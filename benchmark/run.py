#!/usr/bin/env python3
"""The benchmark of ``tdspa_torch`` on an NVIDIA GPU: one run of one cell.

    python3 benchmark/run.py --workload spa3d.tail --seed 7 --seconds 30 --trace 0

From the root of a checkout. Set-up builds or loads the port's kernels
(``build/tdspa_torch/`` in the checkout), makes the weights and the traffic
from ``--seed`` on the card and warms up the cell's shapes; then requests or
steps run back to back for ``--seconds``; then the timed path's outputs are
held to the plain reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``, each compared
number with its limit (also the last lines of standard error).

Caches stay in the checkout: the port's kernels in ``build/tdspa_torch/``,
Python's bytecode in ``build/pycache/``.

Exits non-zero, printing no result, without a CUDA device (it never falls
back to the CPU), without the port, or if the process holds JAX, flax or
the JAX package once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402
import sys  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Compiled bytecode of every module the run imports (torch's included) is
# kept at a fixed path in the checkout, also where the environment turns the
# writing of bytecode off, so that only a checkout's first run compiles it.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Libraries the port may load take no JAX, flax or network with them.
    for key, value in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"),
                       ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[key] = value
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner, spec

    try:
        cell = spec.cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"torch finds {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    except (runner.RunError, ImportError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    runner.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
