"""Model flops utilisation of the semantic path: the DINOv2 backbone's
matrix-product and attention flops over the video's real frames
(``work/vit.py``) plus the tail's forward (``work/model_flops.py``, the DINO
projection at the configuration's width), per request, times the window's
requests, over the window, over the bf16 dense peak, in %."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS
from benchmark.work import vit
from benchmark.work.model_flops import forward_flops


def read(run):
    t = run.traffic
    flops = vit.forward_flops(run.config["backbone"], t["frames"], t["height"], t["width"])
    flops += forward_flops(run.config, 1, t["support"], t["queries"], t["frames"])
    return 100.0 * flops * run.window.count / run.window.seconds / PEAK_BF16_FLOPS
