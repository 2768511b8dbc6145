"""The profiler's trace reduced to what the metrics read.

Device operations are the trace's CUDA-side events (kernels, copies,
sets), user annotations left out.  The window runs from the first to the
last of the harness's top-level ``record_function`` ranges (its own work
and each cluster step, which follow one another through the traced
loop).  Busy time is the union of the device operations' intervals inside
it; an idle gap is a stretch with none, named after the innermost of the
harness's ranges the host was in at its middle."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    idle: Dict[str, float] = field(default_factory=dict)

    def kernel(self, part: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        ``part``."""
        sec = sum(s for n, (s, _) in self.ops.items() if part in n)
        cnt = sum(c for n, (_, c) in self.ops.items() if part in n)
        return sec, cnt

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n[:160], s) for n, (s, _) in self.ops.items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _span(e) -> Tuple[int, int]:
    start = e.start_ns()
    return start, start + e.duration_ns()


def reduce(prof, ranges, top) -> Trace:
    events = prof.profiler.kineto_results.events()
    names = set(ranges)
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name in names or e.is_user_annotation():
                continue
            a, b = _span(e)
            dev.append((a, b, name))
        elif name in names:
            a, b = _span(e)
            host.append((a, b, name))
    outer = [(a, b) for a, b, n in host if n in top]
    if not outer:
        raise RuntimeError("the trace holds none of the harness's ranges")
    w0, w1 = min(a for a, _ in outer), max(b for _, b in outer)
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    clipped = []
    for a, b, n in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops[n][0] += (b - a) / 1e9
        ops[n][1] += 1
        clipped.append((a, b))
    clipped.sort()
    busy, gaps = 0, []
    end = w0
    for a, b in clipped:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < w1:
        gaps.append((end, w1))
    inner = sorted(host, key=lambda h: h[1] - h[0])
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        label = next((n for s, e, n in inner if s <= mid <= e), "between")
        idle[label] += (b - a) / 1e9
    return Trace((w1 - w0) / 1e9, busy / 1e9,
                 {n: (v[0], int(v[1])) for n, v in ops.items()}, dict(idle))
