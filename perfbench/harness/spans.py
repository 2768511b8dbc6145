"""Readers of the program's own spans and counters over a run's window.

The program records spans inside its serving path while
``cluster.tracer`` is on (``repro_torch/serving/tracing.py``: name, start
and end on ``time.perf_counter_ns()``, the harness's clock in
nanoseconds, parent, request ids) and keeps counters that are always on.
A run carries them as ``run.program_spans`` (the tracer's spans) and, in
``run.stats_open`` / ``run.stats_close``, the counters of
:func:`counters` beside the prefill engine's.  A program without them (an
older one) leaves both out, and every reader here returns None."""
from __future__ import annotations

from typing import List, Optional

from harness import readers

# the program's spans that are profiler ranges (``cluster.queue`` is
# recorded from stamps and has none)
PROGRAM_SPANS = ("cluster.tick", "cluster.schedule", "router.route",
                 "prefill.batch", "prefill.match", "prefill.pass",
                 "prefill.dispatch", "prefill.wait", "prefill.store",
                 "decode.admit", "decode.step", "decode.dispatch",
                 "decode.wait", "decode.bookkeep", "cluster.telemetry")


def counters(cluster) -> dict:
    """The program's cumulative counters where it keeps them: routing
    attempts and placements, blocks admitted to the decoders and those
    the hand-off moved (summed over decoders), prefix-cache lookups, hits
    and evictions."""
    out = {}
    if hasattr(cluster, "route_attempts"):
        out["route_attempts"] = float(cluster.route_attempts.value)
        out["placements"] = float(cluster.placements.value)
    decs = cluster.decoders
    if all(hasattr(d, "admitted_blocks") for d in decs):
        out["admitted_blocks"] = float(sum(d.admitted_blocks for d in decs))
        out["transferred_blocks"] = float(sum(d.transferred_blocks
                                              for d in decs))
    st = cluster.prefill.stats
    for key in ("lookups", "hits", "evictions"):
        if hasattr(st, key):
            out[key] = float(getattr(st, key))
    return out


def delta(run, key) -> Optional[float]:
    """A counter's growth over the window, None where it is not kept."""
    a, b = run.stats_open.get(key), run.stats_close.get(key)
    return None if a is None or b is None else b - a


def in_window(run, name: str) -> List:
    """The program's spans named ``name`` that started in the window, as
    (start, end) in seconds."""
    spans = getattr(run, "program_spans", None) or ()
    out = []
    for s in spans:
        if s is not None and s.name == name and run.w0 <= s.t0 / 1e9 < run.w1:
            out.append((s.t0 / 1e9, s.t1 / 1e9))
    return out


def mean_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the spans named ``name`` in the window."""
    return readers.mean_ms(in_window(run, name))


def attempts_per_placement(run) -> Optional[float]:
    """Routing calls per request placed on a decode slot in the window,
    retries under backpressure included."""
    tried, placed = delta(run, "route_attempts"), delta(run, "placements")
    if tried is None or not placed:
        return None
    return tried / placed


def queue_wait_p50_ms(run) -> Optional[float]:
    """Median wait from ``submit`` to placement of the requests placed in
    the window before the profiler opened (where it did)."""
    spans = getattr(run, "program_spans", None) or ()
    lo = run.w0
    hi = run.w1 if run.traced_from is None else run.traced_from
    waits = [(s.t1 - s.t0) / 1e9 for s in spans
             if s is not None and s.name == "cluster.queue"
             and lo <= s.t1 / 1e9 < hi]
    p50 = readers.percentile(waits, 50)
    return None if p50 is None else 1e3 * p50


def resident_share(run) -> Optional[float]:
    """Share of the blocks admitted to the decoders in the window that the
    chosen decoder already held (so the hand-off did not move them)."""
    admitted = delta(run, "admitted_blocks")
    moved = delta(run, "transferred_blocks")
    if admitted is None or moved is None or admitted <= 0:
        return None
    return 1.0 - moved / admitted


def clock_offsets(spans, events, since: float) -> List[int]:
    """Nanoseconds from each profiler range's start to its span's start on
    ``perf_counter_ns``: the ranges, ``(name, start_ns)`` on the
    profiler's clock, in start order, paired with the spans that opened
    from ``since`` (seconds, when the profiler opened) on, in start order.
    Empty where their names do not pair up one for one."""
    events = sorted(events, key=lambda e: e[1])
    ranged = sorted((s for s in spans if s is not None
                     and s.name in PROGRAM_SPANS and s.t0 >= since * 1e9),
                    key=lambda s: s.t0)[:len(events)]
    if [s.name for s in ranged] != [e[0] for e in events]:
        return []
    return [s.t0 - e[1] for s, e in zip(ranged, events)]
