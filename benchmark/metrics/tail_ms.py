"""Milliseconds per tail request: the window (first measured request's start
to the last completed request's end) over the requests it completed."""


def read(run):
    return run.window.mean_s() * 1e3
