"""Share of the decode step's byte roofline, in percent, over the traced
decode steps: their least bytes (the architecture's ``decode_bytes``:
weights once, each live row's embedding row, its recurrent state read and
written once and its K/V below its position) at the card's published
bandwidth, over the device's time in them.  That time is the union of the
device's operations inside the steps: their ``decode`` ranges less the
trace's idle gaps that fall in one (a gap goes to the range its middle lies
in).  It falls where a step moves the state more than once.  Nothing where
the architecture does not count those bytes or the run was not traced."""
from harness import work


def read(run):
    count = getattr(run.arch, "decode_bytes", None)
    tr = run.trace
    if (count is None or tr is None or not run.traced_steps
            or not run.device.startswith("cuda")):
        return None
    # the steps recorded from the profiler's start are the traced ones
    n = len(run.traced_steps)
    spans = [(t0, t1) for t0, t1, _, _ in run.decode_steps
             if t0 >= run.traced_from][:n]
    busy = sum(t1 - t0 for t0, t1 in spans) - tr.idle.get("decode", 0.0)
    if len(spans) < n or busy <= 0:
        return None
    moved = sum(count(run.model, live) for _, live in run.traced_steps)
    bw = work.peaks(run.device_kind)["hbm_bytes_per_s"]
    return 100.0 * moved / (busy * bw)
