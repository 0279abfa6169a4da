"""Training-step time and peak memory of two checkouts on one card, in turns.

    python3 tdspa_torch/tools/ab_train_steps.py PARENT_DIR CHANGE_DIR

runs PARENT, CHANGE, CHANGE, PARENT, each in a process of its own with the
checkout as working directory (so that its ``chip_smoke.py`` and
``tdspa_torch`` are the ones imported and its kernels are built from its own
sources): the default 3DSPA and TRAJAN models at ``chip_smoke.py``'s training
configuration (bf16, fused attention, chunks of 256, batch 2, 2048 support
and 2048 query tracks of 150 frames, seeded), 4 train steps each. Prints one
JSON line per (checkout, model): step ms, the median of the warm 3, peak GB
(``max_memory_allocated`` over the steps) and the last loss. Needs a GPU.
Uses only names that ``chip_smoke.py`` has had since its training phases
came in, so an older checkout runs it too.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

STEPS = 4


def measure(label: str) -> None:
    """The steps of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    for model_type in ("3dspa", "trajan"):
        batch = cs.train_batch(model_type)
        state, model, optimizer, schedule = cs.create_model_state(
            cs.SEED, model_type=model_type, learning_rate=cs.TRAIN_LR, warmup_steps=1,
            total_steps=100 * cs.TRAIN_STEPS, num_output_frames=cs.NUM_FRAMES, device="cuda",
            dtype=torch.bfloat16, fused_attention=True,
            encoder_scan_chunk_size=cs.TRAIN_CHUNK, decoder_scan_chunk_size=cs.TRAIN_CHUNK)
        step = cs.make_train_step(model, optimizer, schedule)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(STEPS):
            (state, metrics), ms = cs._timed_call(step, state, batch)
            times.append(ms)
        print(json.dumps({"ab": label, "model": model_type, "step_ms": times,
                          "median_warm_ms": statistics.median(times[1:]),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "loss": metrics["train/loss"].item()}), flush=True)
        del state, model, optimizer, schedule, step, batch, metrics
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        measure(argv[1])
        return 0
    parent, change = (os.path.abspath(p) for p in argv)
    rc = 0
    for label, tree in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", label],
                              cwd=tree, capture_output=True, text=True, timeout=1200)
        print("\n".join(line for line in proc.stdout.splitlines() if line.startswith('{"ab"')),
              flush=True)
        if proc.returncode:
            print(f"{label} ({tree}) failed:\n{proc.stderr[-3000:]}", file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
