"""Seconds from process start to the window's opening: imports, the
kernels' build or load, weights, warm-up, and the traffic's own fill."""


def read(run):
    return run.setup_s
