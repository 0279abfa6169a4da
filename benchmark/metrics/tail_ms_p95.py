"""95th percentile (nearest rank) of the latencies of every request in the
window, each from its call to the synchronise that ends it, in ms."""


def read(run):
    return run.window.percentile_s(95) * 1e3
