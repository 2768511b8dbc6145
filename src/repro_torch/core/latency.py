"""Latency model of Section 5: linear regime (Eq. 8) plus the singular
saturation term (Eq. 9), and the regime-transition signal (Prop. 4(iii)).

    f_j(n) = a_j·n + b_j + d_j / (n_sat − n)^β        (n < n_sat)

The pole at ``n_sat`` is what drives the PoA divergence; beyond the pole we
model explicit queueing (handled by the simulator's queues, not by this
function), so ``f_j`` is clamped at ``n_sat - margin``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LatencyParams:
    a: float = 0.005          # linear slope (s per in-flight request)
    b: float = 0.020          # base latency (s)
    d: float = 0.010          # singular-term scale
    beta: float = 2.0         # pole severity
    n_sat: float = 64.0       # saturation point (in-flight requests)


# The paper's frozen PoA cost-matrix parameters (Section 6.4) — deliberately
# NOT fitted to observed latencies; they define the relative-efficiency index.
POA_FROZEN = LatencyParams(a=0.005, b=0.020, d=0.010, beta=2.0, n_sat=64.0)
POA_CACHE_WEIGHT = 0.015      # w_c in the Hungarian cost matrix


def latency(n, p: LatencyParams = POA_FROZEN, margin: float = 1.0):
    """Eq. 8/9 latency for load n (array-friendly)."""
    n = np.asarray(n, dtype=np.float64)
    n_eff = np.minimum(n, p.n_sat - margin)
    sing = p.d / np.power(p.n_sat - n_eff, p.beta)
    return p.a * n + p.b + sing


def latency_second_derivative(n, p: LatencyParams = POA_FROZEN):
    """f''(n) = β(β+1)·d/(n_sat−n)^{β+2} — diverges at the pole; the
    theoretical saturation signal of Prop. 4(iii)."""
    n = np.asarray(n, dtype=np.float64)
    gap = np.maximum(p.n_sat - n, 1e-9)
    return p.beta * (p.beta + 1) * p.d / np.power(gap, p.beta + 2)


def routing_cost(n_j, overlap, p: LatencyParams = POA_FROZEN,
                 w_c: float = POA_CACHE_WEIGHT):
    """The frozen-parameter per-(request, worker) cost used by the PoA
    estimator's Hungarian denominator:  c_ij = a·n_j + b + d/(C_j−n_j)^β −
    w_c·o_ij  (Section 6.4)."""
    return latency(n_j, p) - w_c * np.asarray(overlap, dtype=np.float64)
