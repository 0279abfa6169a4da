"""Share of its roofline that the attention backward (``csrc/attention_backward.cu``:
``attention_backward_kernel`` and ``sum_chunks_kernel``) reaches in the 3DSPA
training step: the least time of the backward of every attention call of
the forward, at the shapes the plain reference uses for the job's batch
(the traffic file's ``job``), times the traced steps, over the kernels'
device time in the trace, in %."""

from benchmark.work.attention import backward_bound_s, forward_calls

KERNELS = ("attention_backward_kernel", "sum_chunks_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    t = run.traffic
    calls = forward_calls(run.config, t["job"]["batch_size"], t["support"], t["queries"],
                          t["frames"])
    return 100.0 * sum(backward_bound_s(c) for c in calls) * run.trace.requests / seconds
