"""Share of its roofline that the ViT's maskless attention (``csrc/vit_attention.cu``:
``vit_attention_kernel``) reaches in the depth path: the least time of every launch of a
request (``work/vda.py``: 24 layers x 7 windows of 32 frames for a 150-frame video, each
(32, 1370, 1370, 16, 64); the output written in bf16, as the kernel writes it for a bf16
encoder), times the traced requests, over the kernel's device time in the trace, in %."""

from benchmark.work.vda import attention_calls
from benchmark.work.vit import attention_bound_s

KERNELS = ("vit_attention_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    t = run.traffic
    calls = attention_calls(run.config["depth"], t["frames"], t["height"], t["width"])
    return 100.0 * sum(attention_bound_s(c, out_bytes=2) for c in calls) * \
        run.trace.requests / seconds
