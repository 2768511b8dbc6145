"""Prometheus-style in-process metrics: gauges, counters, histograms with
percentile queries, and sliding windows — the observability substrate the
paper's controller polls (game_poa, game_saturation_state,
game_router_temperature, game_routing_cost)."""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class Gauge:
    def __init__(self, name: str, desc: str = ""):
        self.name, self.desc = name, desc
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Counter:
    def __init__(self, name: str, desc: str = ""):
        self.name, self.desc = name, desc
        self.value = 0.0

    def inc(self, v: float = 1.0):
        self.value += v


class Histogram:
    """Windowed histogram over (timestamp, value) observations."""

    def __init__(self, name: str, desc: str = "", window_s: float = 60.0):
        self.name, self.desc = name, desc
        self.window_s = window_s
        self._obs: Deque[Tuple[float, float]] = deque()

    def observe(self, value: float, now: float):
        self._obs.append((now, value))
        self._trim(now)

    def _trim(self, now: float):
        while self._obs and self._obs[0][0] < now - self.window_s:
            self._obs.popleft()

    def values(self, now: Optional[float] = None) -> List[float]:
        if now is not None:
            self._trim(now)
        return [v for _, v in self._obs]

    def percentile(self, q: float, now: Optional[float] = None) -> float:
        vs = sorted(self.values(now))
        if not vs:
            return 0.0
        idx = min(len(vs) - 1, max(0, math.ceil(q / 100.0 * len(vs)) - 1))
        return vs[idx]

    def p99(self, now: Optional[float] = None) -> float:
        return self.percentile(99.0, now)

    def mean(self, now: Optional[float] = None) -> float:
        vs = self.values(now)
        return sum(vs) / len(vs) if vs else 0.0

    def count(self, now: Optional[float] = None) -> int:
        return len(self.values(now))

    def frac_above(self, threshold: float, now: Optional[float] = None) -> float:
        """Fraction of windowed observations above ``threshold`` — the SLO
        violation rate the Game 1 Planner polls (0.0 on an empty window)."""
        vs = self.values(now)
        if not vs:
            return 0.0
        return sum(1 for v in vs if v > threshold) / len(vs)


class MetricsRegistry:
    """Named registry; ``export_text()`` emits Prometheus exposition format."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def gauge(self, name: str, desc: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, desc))

    def counter(self, name: str, desc: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, desc))

    def histogram(self, name: str, desc: str = "", window_s: float = 60.0) -> Histogram:
        return self._get(name, lambda: Histogram(name, desc, window_s))

    def _get(self, name, factory):
        if name not in self._metrics:
            self._metrics[name] = factory()
        return self._metrics[name]

    def export_text(self, now: Optional[float] = None) -> str:
        lines = []
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, (Gauge, Counter)):
                lines.append(f"# HELP {name} {m.desc}")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# HELP {name} {m.desc}")
                lines.append(f"{name}_count {m.count(now)}")
                lines.append(f"{name}_p50 {m.percentile(50, now)}")
                lines.append(f"{name}_p99 {m.p99(now)}")
        return "\n".join(lines) + "\n"
