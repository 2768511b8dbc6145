"""The 99th percentile of the gaps between consecutive tokens of a
request, in ms, over every gap that ends in the window before the
profiler opens."""
from harness import readers


def read(run):
    v = readers.percentile(readers.itls(run, readers.before_trace(run)), 99)
    return None if v is None else 1e3 * v
