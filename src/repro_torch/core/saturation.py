"""Saturation detector (Section 6.2).

EWMA of TTFT P99 (Eq. 10):  L̄(t) = α·L(t) + (1−α)·L̄(t−Δ),  α = 0.3,
polled every Δ = 5 s.  Regime classification (Eq. 11) with k-consecutive
hysteresis:

    BELOW       L̄ < θ1
    TRANSITION  θ1 ≤ L̄ < θ2
    SATURATED   L̄ ≥ θ2

Model-specific thresholds (paper §6.2): 70B θ1=0.3 s, θ2=2 s; 340B θ1=1.0 s,
θ2=10 s — recommended as 3–5× the model's baseline TTFT P99.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Regime(enum.IntEnum):
    BELOW = 0
    TRANSITION = 1
    SATURATED = 2


@dataclass
class DetectorConfig:
    theta1: float = 0.3          # seconds
    theta2: float = 2.0
    alpha: float = 0.3           # EWMA responsiveness
    poll_interval: float = 5.0
    hysteresis_k: int = 2        # consecutive samples to switch regime
    epsilon: float = 0.05        # downward hysteresis margin on θ1

    @classmethod
    def for_model(cls, name: str) -> "DetectorConfig":
        if "340b" in name.lower() or "nemotron" in name.lower():
            return cls(theta1=1.0, theta2=10.0)
        return cls(theta1=0.3, theta2=2.0)

    @classmethod
    def from_baseline_ttft(cls, baseline_p99: float) -> "DetectorConfig":
        """θ1 as ~4× baseline TTFT P99 (paper recommendation), θ2 = 10×θ1."""
        t1 = 4.0 * baseline_p99
        return cls(theta1=t1, theta2=10.0 * t1)


@dataclass
class SaturationDetector:
    config: DetectorConfig = field(default_factory=DetectorConfig)
    ewma: Optional[float] = None
    regime: Regime = Regime.BELOW
    _pending: Optional[Regime] = None
    _pending_count: int = 0
    history: List[Tuple[float, float, int]] = field(default_factory=list)
    transitions: List[Tuple[float, int, int]] = field(default_factory=list)

    def observe(self, ttft_p99: float, now: float) -> Regime:
        """Feed one polled TTFT P99 sample; returns the (possibly new) regime."""
        c = self.config
        if self.ewma is None:
            self.ewma = float(ttft_p99)
        else:
            self.ewma = c.alpha * float(ttft_p99) + (1 - c.alpha) * self.ewma
        raw = self._classify(self.ewma)
        if raw != self.regime:
            if self._pending == raw:
                self._pending_count += 1
            else:
                self._pending = raw
                self._pending_count = 1
            if self._pending_count >= c.hysteresis_k:
                self.transitions.append((now, int(self.regime), int(raw)))
                self.regime = raw
                self._pending = None
                self._pending_count = 0
        else:
            self._pending = None
            self._pending_count = 0
        self.history.append((now, self.ewma, int(self.regime)))
        return self.regime

    def _classify(self, l: float) -> Regime:
        c = self.config
        # downward transitions require dropping ε below the threshold
        if self.regime >= Regime.TRANSITION:
            if l < c.theta1 - c.epsilon:
                return Regime.BELOW
            if l < c.theta2 - c.epsilon and self.regime == Regime.SATURATED:
                return Regime.TRANSITION
            if l >= c.theta2:
                return Regime.SATURATED
            return self.regime
        if l >= c.theta2:
            return Regime.SATURATED
        if l >= c.theta1:
            return Regime.TRANSITION
        return Regime.BELOW
