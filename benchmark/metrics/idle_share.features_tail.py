"""Share of the traced window in which no operation runs on the card (the
union of kernel, copy and set intervals is the busy time), in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.idle_share
