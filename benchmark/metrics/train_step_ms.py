"""Milliseconds per training step: the window (first measured step's start to
the last completed step's end) over the steps it completed."""


def read(run):
    return run.window.mean_s() * 1e3
