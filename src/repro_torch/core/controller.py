"""Game-theoretic adaptive controller (Section 6, Algorithm 1).

Maps the detected saturation regime to router parameters (Table 2):

    BELOW       τ=0.0, ω=1.0   exploit cache locality (PoA bounded)
    TRANSITION  τ=0.7, ω=1.0   calibrated optimum from the 70B 1P/5D sweep
    SATURATED   τ=0.8, ω=0.1   conjectural row (flagged; never fired in the
                               paper's Exp. 3 — kept for completeness)

and applies them per-request through the router's
``router_config_override`` hook.  Also exports the paper's four Prometheus
metrics (game_poa, game_saturation_state, game_router_temperature,
game_routing_cost) and supports the zero-downtime dual-frontend variant
(two pre-configured routers; the workload switches target on detection).

:class:`AdaptiveRouter` is the standalone Algorithm-1 wrapper; the serving
stacks route through :class:`repro.serving.control_plane.ControlPlane`,
which folds the same regime gating + metric exports into the shared
backend-agnostic runtime (and adds baseline-policy overlap re-scoring and
decision logging).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.poa import PoATracker
from repro_torch.core.router import KvPushRouter, KvRouterConfig
from repro_torch.core.saturation import Regime, SaturationDetector

REGIME_PARAMS: Dict[Regime, KvRouterConfig] = {
    Regime.BELOW: KvRouterConfig(temperature=0.0, overlap_weight=1.0),
    Regime.TRANSITION: KvRouterConfig(temperature=0.7, overlap_weight=1.0),
    # Conjectural (paper Table 2 §): interpolated, never fired in Exp. 3.
    Regime.SATURATED: KvRouterConfig(temperature=0.8, overlap_weight=0.1),
}


def export_game_metrics(metrics: MetricsRegistry, *, regime: Regime,
                        config: KvRouterConfig, decision_s: float,
                        now: float,
                        poa_tracker: Optional[PoATracker] = None) -> None:
    """The paper's Algorithm-1 Prometheus exports, shared by
    :class:`AdaptiveRouter` and the serving ControlPlane so both runtimes
    publish identical signals."""
    if poa_tracker is not None:
        poa = poa_tracker.current_poa(now)
        if poa == poa:  # not NaN
            metrics.gauge("game_poa", "estimated Price of Anarchy").set(poa)
    metrics.gauge("game_saturation_state",
                  "0=below 1=transition 2=saturated").set(int(regime))
    metrics.gauge("game_router_temperature", "active tau"
                  ).set(config.temperature)
    metrics.gauge("game_overlap_weight", "active omega"
                  ).set(config.overlap_weight)
    metrics.histogram("game_routing_cost", "router decision latency (s)",
                      window_s=60.0).observe(decision_s, now)


def violation_rates(metrics: MetricsRegistry, ttft_slo: float, itl_slo: float,
                    now: float) -> Tuple[float, float]:
    """Polled TTFT/ITL SLO-violation rates from the registry's windowed
    histograms — the Game 1 control-plane signal the Planner reads every
    adjust interval (the paper's per-pool objective V_TTFT / V_ITL)."""
    return (metrics.histogram("ttft", window_s=30.0).frac_above(ttft_slo, now),
            metrics.histogram("itl", window_s=30.0).frac_above(itl_slo, now))


@dataclass
class AdaptiveRouter:
    """Algorithm 1: regime-gated per-request parameter override."""
    router: KvPushRouter
    detector: SaturationDetector
    poa_tracker: Optional[PoATracker] = None
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    regime_params: Dict[Regime, KvRouterConfig] = field(
        default_factory=lambda: dict(REGIME_PARAMS))
    adaptive: bool = True                    # False ⇒ static baseline
    static_config: KvRouterConfig = field(default_factory=KvRouterConfig)

    def route(self, tokens: Sequence[int], now: Optional[float] = None,
              hashes: Optional[Sequence[int]] = None) -> Tuple[int, float]:
        """Returns (worker_id, overlap) and exports the game metrics.

        ``hashes`` is the per-request block-hash memo: callers that
        already chained the prompt's block hashes (serving backends do,
        once per request) pass them through so the router/indexer do not
        rehash the same tokens per decision."""
        now = time.monotonic() if now is None else now
        if self.adaptive:
            cfg = self.regime_params[self.detector.regime]
        else:
            cfg = self.static_config
        t0 = time.perf_counter()
        # ``now`` must reach the router: the indexer evaluates TTL claim
        # freshness against it, and defaulting to t=0 meant cache-claim
        # expiry never fired through the adaptive controller.
        worker, overlap, _ = self.router.best_worker(
            tokens, router_config_override=cfg, now=now, hashes=hashes)
        dt = time.perf_counter() - t0
        export_game_metrics(self.metrics, regime=self.detector.regime,
                            config=cfg, decision_s=dt, now=now,
                            poa_tracker=self.poa_tracker)
        return worker, overlap

    def poll(self, ttft_p99: float, now: float) -> Regime:
        """5 s Prometheus poll → saturation detector update."""
        return self.detector.observe(ttft_p99, now)


@dataclass
class DualFrontend:
    """Zero-downtime switch (Section 6.4): two frontends with fixed configs;
    the workload generator flips the target port on regime detection."""
    default: KvRouterConfig = field(
        default_factory=lambda: KvRouterConfig(temperature=0.0, overlap_weight=1.0))
    optimal: KvRouterConfig = field(
        default_factory=lambda: KvRouterConfig(temperature=0.7, overlap_weight=1.0))
    active_port: int = 8000
    switch_time: Optional[float] = None

    def on_regime(self, regime: Regime, now: float):
        if regime >= Regime.TRANSITION and self.active_port == 8000:
            self.active_port = 8001
            self.switch_time = now
        elif regime == Regime.BELOW and self.active_port == 8001:
            self.active_port = 8000

    def active_config(self) -> KvRouterConfig:
        return self.optimal if self.active_port == 8001 else self.default
