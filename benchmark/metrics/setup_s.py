"""Set-up: process start to the first measured request (build or load,
weights, inputs, warm-up), on the host clock."""


def read(run):
    return run.setup_s
