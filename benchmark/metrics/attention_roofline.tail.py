"""Share of its roofline that the fused attention forward (``csrc/attention.cu``:
``masked_attention_kernel`` and ``merge_chunks_kernel``) reaches in the tail:
the least time of the forward's attention calls, at the shapes the plain
reference uses at the cell's sizes, times the traced requests, over the
kernels' device time in the trace, in %."""

from benchmark.work.attention import forward_bound_s, forward_calls

KERNELS = ("masked_attention_kernel", "merge_chunks_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    t = run.traffic
    calls = forward_calls(run.config, 1, t["support"], t["queries"], t["frames"])
    return 100.0 * sum(forward_bound_s(c) for c in calls) * run.trace.requests / seconds
