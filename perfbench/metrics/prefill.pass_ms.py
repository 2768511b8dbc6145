"""Milliseconds a prompt pass in the window (``PrefillStats.wall_s /
batches``)."""
from harness import readers


def read(run):
    n = readers.stat_delta(run, "batches")
    if n <= 0:
        return None
    return 1e3 * readers.stat_delta(run, "wall_s") / n
