"""Model flops utilisation of the depth path: Video Depth Anything's matrix-product,
convolution and attention flops over every frame pass of the video's windows
(``work/vda.py``) plus the tail's forward (``work/model_flops.py``), per request, times
the window's requests, over the window, over the bf16 dense peak, in %."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS
from benchmark.work import vda
from benchmark.work.model_flops import forward_flops


def read(run):
    t = run.traffic
    flops = vda.forward_flops(run.config["depth"], t["frames"], t["height"], t["width"])
    flops += forward_flops(run.config, 1, t["support"], t["queries"], t["frames"])
    return 100.0 * flops * run.window.count / run.window.seconds / PEAK_BF16_FLOPS
