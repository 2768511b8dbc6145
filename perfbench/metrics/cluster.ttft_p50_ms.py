"""The median time to first token, in ms, over every request due in the
window before the profiler opens, counted from when it was due (open
loop); a request still waiting at the close enters with its wait so far."""
from harness import readers


def read(run):
    v = readers.percentile(readers.ttfts(run, readers.before_trace(run)), 50)
    return None if v is None else 1e3 * v
