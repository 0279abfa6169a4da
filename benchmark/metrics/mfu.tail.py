"""Model flops utilisation of the tail: the forward's matrix-product and
attention flops per request (``work/model_flops.py``) times the window's
requests, over the window, over the bf16 dense peak, in %."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS
from benchmark.work.model_flops import forward_flops


def read(run):
    t = run.traffic
    flops = forward_flops(run.config, 1, t["support"], t["queries"], t["frames"])
    return 100.0 * flops * run.window.count / run.window.seconds / PEAK_BF16_FLOPS
