"""The Planner — Game 1 (prefill/decode GNEP resource allocation).

Implements the three layers the paper describes:

* ``variational_equilibrium`` — the analytical solution of Prop. 1: on the
  constraint manifold G_P + G_D = G, find the split equalizing marginal SLO
  violation improvements (Eq. 5), and the *social optimum* of Remark 1 which
  additionally credits prefill's positive externality on decode.

* ``Planner`` — the runtime best-response dynamic with inertia: ±1 worker per
  adjustment interval (30 s), 3-interval grace period for newly assigned
  decode workers, driven by polled TTFT/ITL violation metrics.  Converges to
  the variational equilibrium under stationary load (validated in tests).

* ``ResponseModel`` — the profiled response curves v_TTFT(G_P) / v_ITL(G_D)
  the paper's pre-deployment profiling step produces, anchored at a runtime
  operating point (measured arrival rate, prefill service time, decode
  residency).  TTFT violations follow an M/M/c Erlang-C wait tail over the
  prefill pool; ITL violations follow a Poisson tail over per-worker decode
  occupancy against the load-dependent ITL curve.  The simulator's Planner
  loop feeds ``marginals()`` to ``Planner.step`` as best-response signals,
  and the PoA tracker evaluates the same curves for the resource-game
  counterfactual — so convergence to ``variational_equilibrium`` of these
  curves is the closed-loop claim Game 1 benchmarks verify.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple



def variational_equilibrium(v_ttft: Callable[[float], float],
                            v_itl: Callable[[float], float],
                            total: int) -> int:
    """Integer split G_P* with |marginal| balance of Eq. 5 (exhaustive scan —
    G is small; convexity makes the crossing unique)."""
    best, best_gap = 1, float("inf")
    for gp in range(1, total):
        gd = total - gp
        m_p = v_ttft(gp + 1) - v_ttft(gp)      # ≤ 0, marginal improvement
        m_d = v_itl(gd + 1) - v_itl(gd)
        gap = abs(m_p - m_d)
        if gap < best_gap:
            best, best_gap = gp, gap
    return best


def social_optimum(v_ttft: Callable[[float], float],
                   v_itl_joint: Callable[[float, float], float],
                   total: int) -> int:
    """argmin_{G_P} V_TTFT(G_P) + V_ITL(G−G_P, G_P) (Remark 1)."""
    costs = [(v_ttft(gp) + v_itl_joint(total - gp, gp), gp)
             for gp in range(1, total)]
    return min(costs)[1]


def erlang_c(c: int, a: float) -> float:
    """P(wait > 0) in an M/M/c queue with offered load ``a`` erlangs
    (iterative Erlang-B recurrence, then the standard C conversion)."""
    if c <= 0 or a >= c:
        return 1.0
    if a <= 0.0:
        return 0.0
    b = 1.0
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    return b / (1.0 - rho + rho * b)


def poisson_sf(k: float, mean: float) -> float:
    """P(X > k) for X ~ Poisson(mean), clamped to [0, 1]."""
    if mean <= 0.0:
        return 0.0
    kk = int(math.floor(k))
    if kk < 0:
        return 1.0
    term = math.exp(-mean)
    if term == 0.0:          # mean so large the pmf underflows: tail ≈ 1
        return 1.0
    cdf = term
    for i in range(1, kk + 1):
        term *= mean / i
        cdf += term
    return max(0.0, min(1.0, 1.0 - cdf))


@dataclass(frozen=True)
class ResponseModel:
    """Game 1 response curves anchored at an observed operating point.

    ``v_ttft(G_P)`` — probability a request's prefill wait exceeds the TTFT
    SLO slack, from the Erlang-C wait tail of an M/M/c queue with c = G_P
    servers at the measured arrival rate and mean prefill service time.

    ``v_itl(G_D)`` — probability a decode worker's occupancy N (Poisson
    around the Little's-law mean λ·T_dec/G_D) pushes the load-dependent ITL
    ``itl_base + itl_slope·N`` past the ITL SLO, plus a linear
    excess-occupancy congestion term once the mean runs past the violation
    knee (admission stalls).

    Both curves are strictly decreasing in their pool size, so the
    best-response dynamic over ``marginals()`` descends to the Prop. 1
    equilibrium.
    """
    arrival_rate: float          # λ measured over the planner window (req/s)
    prefill_service: float       # mean prefill service time per request (s)
    decode_residency: float      # mean decode duration per request (s)
    itl_base: float
    itl_slope: float
    decode_cap: float            # admission slots per decode worker
    ttft_slack: float            # TTFT SLO minus pipelined base latency (s)
    itl_slo: float

    # In the overloaded region the violation *probability* clamps at 1,
    # which would zero the marginals and hand the equilibrium scan spurious
    # flat-region fixed points (adding one worker to a destroyed pool
    # "doesn't help").  Both curves therefore extend past 1 with the excess
    # offered load — a strictly decreasing violation *cost* whose marginals
    # keep pointing the best-response dynamic at the starved pool.

    def v_ttft(self, gp: float) -> float:
        c = int(gp)
        a = self.arrival_rate * self.prefill_service
        if c <= 0:
            return 2.0 + a
        if a >= c:
            return 1.0 + (a - c) / c
        p_wait = erlang_c(c, a)
        mu = 1.0 / max(self.prefill_service, 1e-9)
        return min(1.0, p_wait * math.exp(-(c - a) * mu * self.ttft_slack))

    def v_itl(self, gd: float) -> float:
        g = int(gd)
        n_total = self.arrival_rate * self.decode_residency
        cap = max(self.decode_cap, 1.0)
        if g <= 0:
            return 2.0 + n_total / cap
        n_bar = n_total / g
        n_star = (self.itl_slo - self.itl_base) / max(self.itl_slope, 1e-12)
        knee = min(n_star, cap)
        # Poisson occupancy tail, plus the excess-occupancy congestion term
        # (linear in n̄, so strictly convex decreasing in gd): deep inside
        # saturation the tail alone is flat at 1 for every pool size.
        return poisson_sf(knee, n_bar) + max(0.0, (n_bar - knee) / cap)

    def marginals(self, gp: int, gd: int) -> Tuple[float, float]:
        """Estimated violation-rate reduction from +1 worker per pool —
        the best-response signals the Planner consumes (Eq. 5)."""
        m_p = max(self.v_ttft(gp) - self.v_ttft(gp + 1), 0.0)
        m_d = max(self.v_itl(gd) - self.v_itl(gd + 1), 0.0)
        return m_p, m_d


@dataclass
class PlannerConfig:
    total_workers: int = 3
    adjust_interval: float = 30.0     # seconds
    grace_intervals: int = 3          # grace for newly assigned decode workers
    ttft_slo: float = 1.0             # seconds
    itl_slo: float = 0.050
    min_signal: float = 1e-4          # marginal dead-band: park when healthy
    measure_window: float = 30.0      # window for the ResponseModel inputs
                                      # (λ, prefill service, decode
                                      # residency); SLO violation *rates*
                                      # read the shared 30 s ttft/itl
                                      # telemetry windows
    hysteresis: float = 0.0           # move only if the starved pool's
                                      # signal beats the other by this factor


@dataclass
class Planner:
    """±1-worker best-response dynamic over polled violation rates."""
    config: PlannerConfig = field(default_factory=PlannerConfig)
    prefill_workers: int = 1
    decode_workers: int = 2
    _last_adjust: float = 0.0
    _grace_until: float = 0.0
    history: List[Tuple[float, int, int]] = field(default_factory=list)

    def step(self, now: float, ttft_violation: float, itl_violation: float
             ) -> Optional[str]:
        """Called per telemetry poll; may move one worker between pools.
        Returns 'to_prefill' / 'to_decode' / None."""
        c = self.config
        if now - self._last_adjust < c.adjust_interval or now < self._grace_until:
            return None
        move = None
        hyst = 1.0 + c.hysteresis
        if ttft_violation > itl_violation * hyst and self.decode_workers > 1:
            self.prefill_workers += 1
            self.decode_workers -= 1
            move = "to_prefill"
        elif itl_violation > ttft_violation * hyst and self.prefill_workers > 1:
            self.prefill_workers -= 1
            self.decode_workers += 1
            move = "to_decode"
            self._grace_until = now + c.grace_intervals * c.adjust_interval
        if move:
            self._last_adjust = now
            self.history.append((now, self.prefill_workers, self.decode_workers))
        return move
