"""Share of its roofline that the ViT's maskless attention
(``csrc/vit_attention.cu``: ``vit_attention_kernel``) reaches in the semantic
path: the least time of every launch of a request (``work/vit.py``: 40
layers x 19 groups of 8 frames for a 150-frame video in 40-frame upload
chunks), times the traced requests, over the kernel's device time in the
trace, in %."""

from benchmark.work.vit import attention_bound_s, attention_calls

KERNELS = ("vit_attention_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    t = run.traffic
    calls = attention_calls(run.config["backbone"], t["frames"], t["height"], t["width"],
                            t["upload_chunk_frames"])
    return 100.0 * sum(attention_bound_s(c) for c in calls) * run.trace.requests / seconds
