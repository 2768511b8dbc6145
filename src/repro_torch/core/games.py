"""Formal game objects (Section 4) — the analytical layer.

These are *analysis* tools (the paper's point: game theory's value here is
analytical, not algorithmic): explicit normal-form routing games with exact
social-cost/Nash computations on small instances, the potential function for
ω=0 (Rosenthal), and brute-force PoA — used by tests to verify the paper's
structural claims (existence of pure NE at ω=0, potential-game property,
PoA bounds, and the bound's failure once the singular latency term or cache
externalities enter).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency import LatencyParams, latency


@dataclass
class RoutingGame:
    """Atomic routing game Γ_R (Definition 3).

    num_requests players choose among num_workers resources.
    Cost (Eq. 7): C_i(σ) = f_j(n_j(σ)) − ω·o_ij.
    """
    num_requests: int
    num_workers: int
    omega: float = 0.0
    overlap: Optional[np.ndarray] = None      # (requests, workers) o_ij
    latency_fn: Callable[[np.ndarray], np.ndarray] = None

    def __post_init__(self):
        if self.latency_fn is None:
            self.latency_fn = lambda n: 1.0 * n          # affine f(n)=n
        if self.overlap is None:
            self.overlap = np.zeros((self.num_requests, self.num_workers))

    # ------------------------------------------------------------- costs ----

    def loads(self, profile: Sequence[int]) -> np.ndarray:
        n = np.zeros(self.num_workers)
        for j in profile:
            n[j] += 1
        return n

    def player_cost(self, profile: Sequence[int], i: int) -> float:
        n = self.loads(profile)
        j = profile[i]
        return float(self.latency_fn(n[j]) - self.omega * self.overlap[i, j])

    def social_cost(self, profile: Sequence[int]) -> float:
        return sum(self.player_cost(profile, i)
                   for i in range(self.num_requests))

    # -------------------------------------------------------- equilibria ----

    def is_nash(self, profile: Sequence[int]) -> bool:
        profile = list(profile)
        for i in range(self.num_requests):
            cur = self.player_cost(profile, i)
            for j in range(self.num_workers):
                if j == profile[i]:
                    continue
                dev = profile.copy()
                dev[i] = j
                if self.player_cost(dev, i) < cur - 1e-12:
                    return False
        return True

    def enumerate_profiles(self):
        return itertools.product(range(self.num_workers),
                                 repeat=self.num_requests)

    def exact_poa(self) -> Tuple[float, float, float]:
        """Brute force (worst NE cost, optimum cost, PoA). Exponential —
        small instances only (tests)."""
        worst_ne = -np.inf
        opt = np.inf
        for prof in self.enumerate_profiles():
            sc = self.social_cost(prof)
            opt = min(opt, sc)
            if self.is_nash(prof):
                worst_ne = max(worst_ne, sc)
        return worst_ne, opt, worst_ne / opt if opt > 0 else np.inf

    def potential(self, profile: Sequence[int]) -> float:
        """Rosenthal potential Φ(σ) = Σ_j Σ_{k≤n_j} f(k) — exact potential
        iff ω = 0 (Prop. 3.1/3.2)."""
        n = self.loads(profile)
        phi = 0.0
        for j in range(self.num_workers):
            for k in range(1, int(n[j]) + 1):
                phi += float(self.latency_fn(np.asarray(float(k))))
        return phi

    def best_response_dynamics(self, profile: Optional[List[int]] = None,
                               max_rounds: int = 1000) -> Tuple[List[int], int]:
        """Sequential best response; returns (profile, rounds). Converges in
        ≤ n rounds for static congestion games [Fardno & Etesami]."""
        if profile is None:
            profile = [0] * self.num_requests
        for rnd in range(max_rounds):
            changed = False
            for i in range(self.num_requests):
                costs = []
                for j in range(self.num_workers):
                    dev = profile.copy()
                    dev[i] = j
                    costs.append(self.player_cost(dev, i))
                best = int(np.argmin(costs))
                if best != profile[i]:
                    profile[i] = best
                    changed = True
            if not changed:
                return profile, rnd + 1
        return profile, max_rounds

    def greedy_sequential(self, order: Optional[Sequence[int]] = None
                          ) -> List[int]:
        """Dynamo-router-style arrival-order greedy assignment (the mechanism
        whose PoA the paper measures)."""
        order = order if order is not None else range(self.num_requests)
        profile = [-1] * self.num_requests
        loads = np.zeros(self.num_workers)
        for i in order:
            c = self.latency_fn(loads + 1) - self.omega * self.overlap[i]
            j = int(np.argmin(c))
            profile[i] = j
            loads[j] += 1
        return profile


def singular_game(num_requests: int, num_workers: int,
                  params: LatencyParams = LatencyParams(n_sat=8.0),
                  omega: float = 0.0, overlap=None) -> RoutingGame:
    """Routing game with the Eq. 9 singular latency (pole at n_sat)."""
    return RoutingGame(num_requests, num_workers, omega=omega,
                       overlap=overlap,
                       latency_fn=lambda n: latency(n, params))


@dataclass
class CacheGame:
    """Selfish caching game Γ_KV (Definition 2) on a small worker graph.

    Strategy per (worker, block): cache locally or fetch remotely/recompute.
    Used by tests to verify Prop. 2: pure NE exist; on complete graphs with
    uniform distance ≥ local cost, selfish caching is socially optimal
    (PoA=1).
    """
    num_workers: int
    num_blocks: int
    alpha: float = 1.0                        # local caching/placement cost
    gamma: float = 10.0                       # recompute cost
    distance: Optional[np.ndarray] = None     # (w, w) network cost

    def __post_init__(self):
        if self.distance is None:
            d = np.ones((self.num_workers, self.num_workers))
            np.fill_diagonal(d, 0.0)
            self.distance = d

    def worker_cost(self, placement: np.ndarray, w: int) -> float:
        """placement: bool (workers, blocks). Each worker needs every block:
        local → α; remote → min distance to a holder; none → γ."""
        total = 0.0
        for b in range(self.num_blocks):
            if placement[w, b]:
                total += self.alpha
            else:
                holders = np.where(placement[:, b])[0]
                if len(holders) == 0:
                    total += self.gamma
                else:
                    total += float(self.distance[w, holders].min())
        return total

    def social_cost(self, placement: np.ndarray) -> float:
        return sum(self.worker_cost(placement, w)
                   for w in range(self.num_workers))

    def is_nash(self, placement: np.ndarray) -> bool:
        for w in range(self.num_workers):
            cur = self.worker_cost(placement, w)
            for b in range(self.num_blocks):
                flip = placement.copy()
                flip[w, b] = ~flip[w, b]
                if self.worker_cost(flip, w) < cur - 1e-12:
                    return False
        return True

    def best_response_dynamics(self, max_rounds: int = 100) -> np.ndarray:
        placement = np.zeros((self.num_workers, self.num_blocks), dtype=bool)
        for _ in range(max_rounds):
            changed = False
            for w in range(self.num_workers):
                for b in range(self.num_blocks):
                    cur = self.worker_cost(placement, w)
                    flip = placement.copy()
                    flip[w, b] = ~flip[w, b]
                    if self.worker_cost(flip, w) < cur - 1e-12:
                        placement = flip
                        changed = True
            if not changed:
                break
        return placement
