"""What the metric readers share: the window's requests, gaps and spans
as the harness recorded them, and percentiles over them."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from harness import work


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics), or None."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def ttfts(run, until: Optional[float] = None) -> List[float]:
    """Seconds from each request's due time to its first token, over every
    request due in the window (before ``until`` where given); one still
    waiting at the window's close enters with its wait so far."""
    end_due = run.w1 if until is None else until
    out = []
    for r in run.records.values():
        if not run.w0 <= r.due < end_due:
            continue
        end = r.first if r.first is not None and r.first <= run.w1 else run.w1
        out.append(end - r.due)
    return out


def itls(run, until: Optional[float] = None) -> List[float]:
    """Every gap between consecutive tokens of a request whose later token
    came inside the window (before ``until`` where given)."""
    end = run.w1 if until is None else until
    out = []
    for r in run.records.values():
        t = r.times
        out.extend(b - a for a, b in zip(t, t[1:]) if run.w0 <= b <= end)
    return out


def before_trace(run) -> Optional[float]:
    """When the profiler opened in a traced run (None where it did not):
    the host runs slower under it, and an open loop's queue carries that
    past the trace's close."""
    return run.traced_from


def tokens_in_window(run) -> int:
    return sum(1 for r in run.records.values() for t in r.times
               if run.w0 <= t <= run.w1)


def spans_in_window(run, name):
    return [(a, b) for a, b in run.spans.get(name, []) if run.w0 <= a < run.w1]


def mean_ms(spans) -> Optional[float]:
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)


def stat_delta(run, key) -> float:
    return run.stats_close[key] - run.stats_open[key]


def idle_share(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s


def roofline_pct(run, kernel: str, nbytes) -> Optional[float]:
    """Share of the byte bound: the least time of a launch of ``kernel``
    (``nbytes(lengths)`` of each launch the traced decode steps made, one
    in each layer that attends, at the card's bandwidth, averaged) over its
    mean device time in the trace.  Nothing where the trace holds no launch
    of it, or fewer than 95% of the launches the steps made (the profiler
    can drop a few records under load; the mean of those it kept stands
    for them)."""
    tr = run.trace
    if tr is None or not run.traced_steps or not run.device.startswith("cuda"):
        return None
    sec, count = tr.kernel(kernel)
    made = (run.arch.decode_attention_layers(run.model)
            * len(run.traced_steps))
    if sec <= 0 or not 0.95 * made <= count <= made:
        return None
    per_launch = sum(nbytes([n + 1 for n in lengths])
                     for lengths, _ in run.traced_steps) / len(run.traced_steps)
    bw = work.peaks(run.device_kind)["hbm_bytes_per_s"]
    return 100.0 * (per_launch / bw) / (sec / count)


def step_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the whole window (every prompt pass and every decode
    step, attention at each length) over the window at the card's published
    bf16 peak, in percent."""
    if not run.device.startswith("cuda"):
        return None
    m = run.model
    flops = sum(f for t, f in run.passes if run.w0 <= t < run.w1)
    flops += sum(run.arch.decode_flops(m, live)
                 for t0, _, _, live in run.decode_steps
                 if run.w0 <= t0 < run.w1)
    peak = work.peaks(run.device_kind)["bf16_flops_per_s"]
    return 100.0 * flops / ((run.w1 - run.w0) * peak)
