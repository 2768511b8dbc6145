"""Milliseconds spent in ``ControlPlane.route`` per placement in the
window: every routing call, retries under backpressure included, over the
requests placed."""
from harness import readers


def read(run):
    spans = readers.spans_in_window(run, "route")
    placed = [t for t in run.placements if run.w0 <= t < run.w1]
    if not spans or not placed:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(placed)
