"""Workload generation (paper Section 7.4) — closed-loop, open-loop, trace.

Three workload modes, selected by ``WorkloadConfig.mode``:

``closed``
    The paper's short-chat profile: 5 prompt templates × 128 input tokens,
    256 max output tokens, deterministic generation.  Closed-loop clients
    hold a target concurrency via a semaphore; each phase has a linear ramp
    then a hold.

``open``
    Open-loop arrival processes decoupled from service completions: Poisson
    (stationary rate), bursty on/off (MMPP-style two-rate switching), and a
    diurnal sinusoid (nonhomogeneous Poisson via thinning).  These are the
    non-stationary traffic shapes the scenario registry exercises — under
    open-loop arrivals saturation is an input property, not an emergent one.

``trace``
    Replay of a recorded request trace.  The JSONL schema is one object per
    line with fields::

        {"t": <arrival time, s>,            # required, non-decreasing
         "template": <int>,                 # optional, default 0
         "input_tokens": <int>,             # optional, default workload's
         "output_tokens": <int>}            # optional, default workload's

    Load a file with :meth:`WorkloadConfig.from_trace_file` or build one
    in-memory with :meth:`WorkloadConfig.from_records`.

All modes are deterministic given the simulator seed: open-loop arrival
times are drawn from a dedicated generator so closed-loop runs are
byte-identical to the pre-scenario-subsystem simulator.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

NUM_TEMPLATES = 5
INPUT_TOKENS = 128
OUTPUT_TOKENS = 256

# The paper's short-chat template popularity (mildly skewed — what lets
# cache-affinity herding concentrate load).  Shared by both backends so the
# analytic simulator and the engine cluster sample identical template
# streams from identical seeds.
TEMPLATE_POPULARITY = (0.35, 0.25, 0.20, 0.12, 0.08)


def template_mix(num_templates: int) -> Tuple[float, ...]:
    """Template popularity distribution for a ``num_templates``-wide mix.

    The legacy 5-template mix verbatim (identity path, keeps pre-scenario
    runs bit-exact), or a Zipf(0.9) skew when the workload asks for a wider
    template universe (cache-pressure scenarios grow the working set past
    G1 this way)."""
    if num_templates == len(TEMPLATE_POPULARITY):
        return TEMPLATE_POPULARITY
    w = [1.0 / (i + 1) ** 0.9 for i in range(num_templates)]
    tot = sum(w)
    return tuple(x / tot for x in w)


def template_tokens(template_id: int, n_tokens: int = INPUT_TOKENS) -> List[int]:
    """Deterministic token ids per template (shared prefixes per template)."""
    base = template_id * 100_000
    return [base + i for i in range(n_tokens)]


@dataclass(frozen=True)
class Phase:
    target_concurrency: int
    ramp_s: float
    hold_s: float


@dataclass(frozen=True)
class ArrivalProcess:
    """Open-loop arrival process spec.

    ``poisson``  — homogeneous Poisson at ``rate`` req/s.
    ``burst``    — on/off switching: ``burst_rate`` during ``on_s``-long
                   bursts, ``rate`` during ``off_s``-long quiet periods.
    ``diurnal``  — nonhomogeneous Poisson with intensity
                   rate·(1 + amplitude·sin(2πt/period_s)), sampled by
                   thinning against the peak rate.
    """
    kind: str = "poisson"          # poisson | burst | diurnal
    rate: float = 10.0             # baseline arrival rate (req/s)
    burst_rate: float = 40.0       # on-phase rate for kind="burst"
    on_s: float = 10.0             # burst duration
    off_s: float = 30.0            # quiet duration
    period_s: float = 120.0        # diurnal period
    amplitude: float = 0.8         # diurnal modulation depth, in [0, 1)

    def times(self, duration_s: float, rng: np.random.Generator) -> List[float]:
        """Arrival times in [0, duration_s), deterministic given ``rng``."""
        if self.kind == "poisson":
            return self._homogeneous(self.rate, 0.0, duration_s, rng)
        if self.kind == "burst":
            out: List[float] = []
            t = 0.0
            while t < duration_s:
                end_on = min(t + self.on_s, duration_s)
                out.extend(self._homogeneous(self.burst_rate, t, end_on, rng))
                t = end_on
                end_off = min(t + self.off_s, duration_s)
                out.extend(self._homogeneous(self.rate, t, end_off, rng))
                t = end_off
            return out
        if self.kind == "diurnal":
            peak = self.rate * (1.0 + self.amplitude)
            cand = self._homogeneous(peak, 0.0, duration_s, rng)
            out = []
            for t in cand:
                lam = self.rate * (1.0 + self.amplitude
                                   * math.sin(2.0 * math.pi * t / self.period_s))
                if rng.random() * peak <= lam:
                    out.append(t)
            return out
        raise ValueError(f"unknown arrival kind {self.kind!r}")

    @staticmethod
    def _homogeneous(rate: float, t0: float, t1: float,
                     rng: np.random.Generator) -> List[float]:
        if rate <= 0.0 or t1 <= t0:
            return []
        out = []
        t = t0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= t1:
                return out
            out.append(t)


@dataclass(frozen=True)
class TraceEntry:
    """One replayed request. ``template < 0`` means sample from popularity."""
    t: float
    template: int = 0
    input_tokens: int = INPUT_TOKENS
    output_tokens: int = OUTPUT_TOKENS


@dataclass(frozen=True)
class WorkloadConfig:
    phases: Tuple[Phase, ...] = ()
    input_tokens: int = INPUT_TOKENS
    output_tokens: int = OUTPUT_TOKENS
    num_templates: int = NUM_TEMPLATES
    mode: str = "closed"                       # closed | open | trace
    arrival: Optional[ArrivalProcess] = None   # mode="open"
    duration_s: float = 0.0                    # mode="open"
    trace: Tuple[TraceEntry, ...] = ()         # mode="trace"

    # ------------------------------------------------------ constructors ----

    @classmethod
    def single_level(cls, concurrency: int, hold_s: float = 120.0,
                     ramp_s: float = 30.0) -> "WorkloadConfig":
        return cls(phases=(Phase(concurrency, ramp_s, hold_s),))

    @classmethod
    def load_spike(cls, low: int = 32, high: int = 128,
                   durations=(120.0, 180.0, 120.0)) -> "WorkloadConfig":
        """Experiment 3: C = low → high → low."""
        return cls(phases=(Phase(low, 10.0, durations[0]),
                           Phase(high, 10.0, durations[1]),
                           Phase(low, 0.0, durations[2])))

    @classmethod
    def open_loop(cls, arrival: ArrivalProcess, duration_s: float,
                  **kw) -> "WorkloadConfig":
        return cls(mode="open", arrival=arrival, duration_s=duration_s, **kw)

    @classmethod
    def poisson(cls, rate: float, duration_s: float, **kw) -> "WorkloadConfig":
        return cls.open_loop(ArrivalProcess("poisson", rate=rate),
                             duration_s, **kw)

    @classmethod
    def bursty(cls, rate: float, burst_rate: float, duration_s: float,
               on_s: float = 10.0, off_s: float = 30.0, **kw) -> "WorkloadConfig":
        return cls.open_loop(
            ArrivalProcess("burst", rate=rate, burst_rate=burst_rate,
                           on_s=on_s, off_s=off_s), duration_s, **kw)

    @classmethod
    def diurnal(cls, rate: float, duration_s: float, period_s: float = 120.0,
                amplitude: float = 0.8, **kw) -> "WorkloadConfig":
        return cls.open_loop(
            ArrivalProcess("diurnal", rate=rate, period_s=period_s,
                           amplitude=amplitude), duration_s, **kw)

    @staticmethod
    def _validate_record(r, where: str) -> None:
        """One trace record against the JSONL schema; raises ValueError
        naming the offending record (index, or file:line when loaded from
        disk) and the exact field that is malformed."""
        if not isinstance(r, dict):
            raise ValueError(f"trace {where}: expected an object with an "
                             f"arrival time 't', got {type(r).__name__}: "
                             f"{r!r}")
        if "t" not in r:
            raise ValueError(f"trace {where}: missing required field 't' "
                             f"(arrival time in seconds); got fields "
                             f"{sorted(r)}")
        t = r["t"]
        if isinstance(t, bool) or not isinstance(t, (int, float)):
            raise ValueError(f"trace {where}: 't' must be a number "
                             f"(seconds), got {t!r}")
        if not math.isfinite(float(t)) or float(t) < 0.0:
            raise ValueError(f"trace {where}: 't' must be finite and "
                             f">= 0, got {t!r}")
        tpl = r.get("template", 0)
        if isinstance(tpl, bool) or not isinstance(tpl, int):
            raise ValueError(f"trace {where}: 'template' must be an "
                             f"integer id (< 0 samples from popularity), "
                             f"got {tpl!r}")
        for key in ("input_tokens", "output_tokens"):
            if key not in r:
                continue
            v = r[key]
            ok = (not isinstance(v, bool)
                  and isinstance(v, (int, float))
                  and float(v).is_integer() and v > 0)
            if not ok:
                raise ValueError(f"trace {where}: '{key}' must be a "
                                 f"positive integer token count, got "
                                 f"{v!r}")

    @classmethod
    def from_records(cls, records: Sequence[dict],
                     _context: Optional[Sequence[str]] = None,
                     **kw) -> "WorkloadConfig":
        """Build a trace workload from dicts following the JSONL schema.
        Every record is validated first — a malformed entry raises
        :class:`ValueError` naming the record and field, instead of a
        KeyError/TypeError from deep inside the simulator."""
        defaults = dict(input_tokens=kw.get("input_tokens", INPUT_TOKENS),
                        output_tokens=kw.get("output_tokens", OUTPUT_TOKENS))
        entries = []
        for i, r in enumerate(records):
            where = _context[i] if _context is not None else f"record {i}"
            cls._validate_record(r, where)
            entries.append(
                TraceEntry(t=float(r["t"]),
                           template=int(r.get("template", 0)),
                           input_tokens=int(r.get("input_tokens",
                                                  defaults["input_tokens"])),
                           output_tokens=int(r.get("output_tokens",
                                                   defaults["output_tokens"]))))
        return cls(mode="trace",
                   trace=tuple(sorted(entries, key=lambda e: e.t)), **kw)

    @classmethod
    def from_trace_file(cls, path, **kw) -> "WorkloadConfig":
        """Load a JSONL trace (see module docstring for the schema).
        Parse and schema errors carry ``path:line`` context."""
        records: List[dict] = []
        context: List[str] = []
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise ValueError(f"trace {path}:{ln}: invalid JSON "
                                     f"({e.msg} at column {e.colno})") from e
                context.append(f"{path}:{ln}")
        return cls.from_records(records, _context=context, **kw)

    # ----------------------------------------------------------- queries ----

    def total_duration(self) -> float:
        if self.mode == "open":
            return self.duration_s
        if self.mode == "trace":
            return self.trace[-1].t if self.trace else 0.0
        return sum(p.ramp_s + p.hold_s for p in self.phases)

    def concurrency_at(self, t: float) -> int:
        """Target concurrency at absolute time t (linear ramps).

        Open-loop and trace modes have no concurrency target (arrivals do
        not wait for completions) — returns 0 so the closed-loop client
        never submits.
        """
        if self.mode != "closed":
            return 0
        t0 = 0.0
        prev = 0
        for p in self.phases:
            if t < t0 + p.ramp_s:
                frac = (t - t0) / max(p.ramp_s, 1e-9)
                return max(1, int(round(prev + frac * (p.target_concurrency - prev))))
            t0 += p.ramp_s
            if t < t0 + p.hold_s:
                return p.target_concurrency
            t0 += p.hold_s
            prev = p.target_concurrency
        return 0

    def phase_of(self, t: float):
        """Index of the phase active at time t (ramp attributed to its phase).
        Open-loop/trace workloads are single-phase (index 0)."""
        if self.mode != "closed" or not self.phases:
            return 0
        t0 = 0.0
        for i, p in enumerate(self.phases):
            t0 += p.ramp_s + p.hold_s
            if t < t0:
                return i
        return len(self.phases) - 1

    def arrivals(self, rng: np.random.Generator) -> List[TraceEntry]:
        """Materialized arrival list for open/trace modes ([] for closed).

        Open-loop entries carry ``template=-1`` — the simulator samples the
        template from its popularity distribution at arrival time, matching
        closed-loop template statistics.
        """
        if self.mode == "trace":
            return list(self.trace)
        if self.mode == "open":
            assert self.arrival is not None, "open mode needs an arrival spec"
            return [TraceEntry(t=t, template=-1,
                               input_tokens=self.input_tokens,
                               output_tokens=self.output_tokens)
                    for t in self.arrival.times(self.duration_s, rng)]
        return []
