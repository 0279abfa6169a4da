"""Model flops utilisation of the 3DSPA training step: 3 x the forward's
matrix-product and attention flops (forward and backward, no recompute) of
the job's batch (the traffic file's ``job``), times the window's steps,
over the window, over the bf16 dense peak, in %."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS
from benchmark.work.model_flops import forward_flops


def read(run):
    t = run.traffic
    flops = 3 * forward_flops(run.config, t["job"]["batch_size"], t["support"], t["queries"],
                              t["frames"])
    return 100.0 * flops * run.window.count / run.window.seconds / PEAK_BF16_FLOPS
