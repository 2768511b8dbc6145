"""Empirical Price-of-Anarchy estimator (Section 6.4, Eq. 12).

    PoA(t) = Σ_{q ∈ W(t)} L_q^actual  /  OPT(W(t))

OPT is a hindsight-optimal assignment of the windowed requests to workers,
computed with the Hungarian algorithm on a *frozen-latency* cost matrix
(paper parameters a=0.005, b=0.020, d=0.010, β=2, C_j=64, w_c=0.015 — an
uncalibrated relative-efficiency index, NOT an absolute efficiency ratio).
Because routing is many-to-one, each worker column is replicated up to its
capacity so the one-to-one optimal assignment lower-bounds the many-to-one
optimum.  The index can fall below 1 when the greedy router exploits KV
overlap the frozen matrix approximates imperfectly (paper §9.2 fn. 2).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence

import numpy as np

from repro_torch.core.latency import POA_FROZEN, POA_CACHE_WEIGHT, LatencyParams
from repro_torch.core.planner import social_optimum, variational_equilibrium


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost one-to-one assignment; returns col index per row.

    Uses scipy's C implementation when available; falls back to the pure
    JV-style implementation below (each validated against the other and
    against brute force in tests). Rectangular (rows ≤ cols) supported.
    """
    try:
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(np.asarray(cost, dtype=np.float64))
        out = np.zeros(cost.shape[0], dtype=np.int64)
        out[rows] = cols
        return out
    except ImportError:
        return hungarian_jv(cost)


def hungarian_jv(cost: np.ndarray) -> np.ndarray:
    """Pure-numpy Jonker–Volgenant shortest augmenting path, O(n³)."""
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    assert n <= m, "need rows <= cols"
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)      # p[j] = row assigned to col j (1-based)
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            for j in range(1, m + 1):
                if used[j]:
                    continue
                c = cur[j - 1]
                if c < minv[j]:
                    minv[j] = c
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    ans = np.zeros(n, dtype=np.int64)
    for j in range(1, m + 1):
        if p[j] > 0:
            ans[p[j] - 1] = j - 1
    return ans


@dataclass
class CompletedRequest:
    request_id: str
    worker: int
    latency: float               # observed end-to-end latency L_q^actual (s)
    overlap: Sequence[float]     # KV overlap score per worker at routing time
    finish_time: float
    loads: Sequence[float] = ()  # per-worker decode load observed at routing
    # fourth game (both 0.0 when no fabric is attached): realized fabric
    # transfer service incl. link queueing, and the uncongested transfer
    # time of the social optimum's link assignment
    transfer_wait: float = 0.0
    transfer_floor: float = 0.0


@dataclass
class PoATracker:
    """Sliding-window PoA estimator over completed requests.

    The window is bounded both in time (``window_s``) and count
    (``window_count``) — the count bound is what makes the below-saturation
    plateau flat: the frozen OPT always prices the same number of windowed
    requests regardless of arrival rate.

    ``dedup`` enables the large-pool OPT fast path: identical replicated
    worker columns collapse into capacitated columns before the Hungarian
    solve (see :meth:`opt_cost`); the dense legacy matrix is kept behind
    ``dedup=False`` and pinned equal in tests.
    """
    num_workers: int
    window_s: float = 30.0
    window_count: int = 128
    capacity: int = 64                  # C_j column replication per worker
    params: LatencyParams = POA_FROZEN
    cache_weight: float = POA_CACHE_WEIGHT
    capacities: Sequence[float] = ()    # per-worker relative capacity (hetero)
    dedup: bool = True                  # collapse identical OPT columns
    _window: Deque[CompletedRequest] = field(default_factory=deque)
    _last: float = float("nan")

    def _capacity_shares(self) -> Optional[np.ndarray]:
        """Per-worker share of total decode capacity, or None when the pool
        is homogeneous (legacy uniform path, bit-exact with the seed)."""
        if not self.capacities or len(set(self.capacities)) <= 1:
            return None
        caps = np.asarray(self.capacities, dtype=np.float64)
        return caps / caps.sum()

    def record(self, req: CompletedRequest):
        self._window.append(req)
        while len(self._window) > self.window_count:
            self._window.popleft()
        while self._window and (self._window[0].finish_time
                                < req.finish_time - self.window_s):
            self._window.popleft()

    def opt_cost(self, reqs: List[CompletedRequest]) -> float:
        """Hungarian OPT on the frozen cost matrix with capacity-replicated
        worker columns.  Per the paper (§6.4) the matrix freezes latencies
        from the observed allocation, ignoring how redistribution would
        change loads: every worker column carries the Eq. 9 latency at the
        window's balanced per-worker load n̄ = |W|/m, minus the cache-overlap
        credit w_c·o_ij.  OPT therefore lower-bounds the attainable optimum
        (the paper's 'PoA is an upper bound' argument).

        Large-pool path (``dedup=True``): workers whose frozen cost column
        is identical over the whole window — the common case, since most
        workers have zero overlap with most requests and equal balanced
        load — collapse into ONE capacitated column replicated
        min(group capacity, n) times.  The capacitated problem has the
        same optimum as the dense matrix (an assignment never uses more
        than n replicas of interchangeable columns), so both the scipy
        path and the JV fallback solve a matrix whose width scales with
        the number of *distinct* columns instead of workers × capacity."""
        n = len(reqs)
        if n == 0:
            return 0.0
        cap = max(1, min(self.capacity, n))
        w = self.num_workers
        from repro_torch.core.latency import latency
        shares = self._capacity_shares()
        if shares is None:
            # homogeneous: every column carries the Eq. 9 latency at the
            # uniform balanced load n̄ = |W|/m
            base_w = np.full(w, float(latency(np.asarray(n / w), self.params)))
            reps = np.full(w, cap, dtype=np.int64)
        else:
            # heterogeneous: the counterfactual balanced load of worker j is
            # capacity-proportional, n̄_j = |W|·C_j/ΣC, and its column count
            # scales with its share of the replication budget.  A worker with
            # zero capacity (a pool slot currently serving prefill under the
            # Game 1 Planner) contributes no columns at all: the routing
            # counterfactual may only redistribute over live decode workers.
            base_w = np.asarray([float(latency(np.asarray(n * s), self.params))
                                 for s in shares])
            reps = np.round(shares * w * cap).astype(np.int64)
            reps[shares > 0] = np.maximum(1, reps[shares > 0])
        cols = int(reps.sum())
        ov = np.zeros((n, w))
        for i, rq in enumerate(reqs):
            o = np.asarray(rq.overlap, dtype=np.float64)
            if o.shape[0] == w:
                ov[i] = o
        per_w = base_w[None, :] - self.cache_weight * ov   # (n, w)
        floors = np.asarray([rq.transfer_floor for rq in reqs],
                            dtype=np.float64)
        if floors.any():
            # fourth game: even OPT must move each request's non-resident
            # KV once, over uncongested links — a per-request constant
            # added to every column (prices the wire without perturbing
            # the assignment).  Skipped entirely when no fabric ran, so
            # fabric=None stays bit-exact.
            per_w = per_w + floors[:, None]
        scale = 1.0
        if n > cols:
            # truncation: price only the first `cols` requests one-to-one,
            # then scale the per-request optimum back up to the window
            per_w = per_w[:cols]
            scale = n / cols
            n = cols
        if self.dedup:
            # group workers by their exact column bytes (no sort needed;
            # insertion order keeps the solve deterministic)
            cols_t = np.ascontiguousarray(per_w.T)
            groups: dict = {}
            for j in range(cols_t.shape[0]):
                groups.setdefault(cols_t[j].tobytes(), []).append(j)
            first = [g[0] for g in groups.values()]
            group_reps = np.minimum(
                np.asarray([int(reps[g].sum()) for g in groups.values()],
                           dtype=np.int64), n)
            cost = np.repeat(per_w[:, first], group_reps, axis=1)
        else:
            cost = np.repeat(per_w, reps, axis=1)          # (n, cols) dense
        idx = hungarian(cost)
        return float(cost[np.arange(n), idx].sum() * scale)

    def window_size(self, now: Optional[float] = None) -> int:
        reqs = list(self._window)
        if now is not None:
            reqs = [r for r in reqs if r.finish_time >= now - self.window_s]
        return len(reqs)

    def resource_game(self, model, prefill_workers: int, total: int) -> dict:
        """Game 1 counterfactual (Section 9.2): the realized P/D split
        against the Prop. 1 variational equilibrium and Remark 1 social
        optimum of the profiled response curves.

        ``model`` is a :class:`repro.core.planner.ResponseModel` (or any
        object exposing ``v_ttft(gp)`` / ``v_itl(gd)``).  The resource-game
        PoA-hat is the social cost V_TTFT(G_P) + V_ITL(G−G_P) at the
        realized split divided by the cost at the social optimum — 1.0 when
        the Planner's best-response dynamic has landed on the coordinated
        split, rising when selfish pool objectives leave workers
        mis-assigned."""
        ve = variational_equilibrium(model.v_ttft, model.v_itl, total)
        so = social_optimum(model.v_ttft, lambda gd, gp: model.v_itl(gd),
                            total)
        cost = lambda gp: model.v_ttft(gp) + model.v_itl(total - gp)
        c_re, c_so = cost(prefill_workers), cost(so)
        # Additive floor at the Planner's dead-band scale: when the whole
        # curve is sub-violation-rate noise (an idle diurnal trough), the
        # raw ratio of two negligible costs would explode while nothing is
        # actually mis-allocated — smoothed, it reads ≈ 1.
        floor = 1e-4
        poa = (c_re + floor) / (c_so + floor)
        return {"gp": prefill_workers, "gd": total - prefill_workers,
                "ve_gp": ve, "so_gp": so, "poa_resource": poa}

    def network_game(self, now: Optional[float] = None) -> dict:
        """Fourth-game counterfactual: realized transfer wait (fabric
        service incl. shared-link queueing) over the window, against the
        social optimum's link assignment — every transfer priced at its
        uncongested path time (``transfer_floor``).  The ratio is the
        network PoA-hat: 1.0 when no transfer ever queued behind another,
        rising as cache-affinity herding serializes transfers on shared
        NICs.  Floored like :meth:`resource_game`: an idle window with
        negligible wire time reads ≈ 1, not 0/0."""
        reqs = list(self._window)
        if now is not None:
            reqs = [r for r in reqs if r.finish_time >= now - self.window_s]
        wait = sum(r.transfer_wait for r in reqs)
        opt = sum(r.transfer_floor for r in reqs)
        floor = 1e-4
        return {"transfer_wait": wait, "transfer_opt": opt,
                "poa_network": (wait + floor) / (opt + floor),
                "n": len(reqs)}

    def current_poa(self, now: Optional[float] = None) -> float:
        reqs = list(self._window)
        if now is not None:
            reqs = [r for r in reqs if r.finish_time >= now - self.window_s]
        if not reqs:
            return float("nan")
        actual = sum(r.latency for r in reqs)
        opt = self.opt_cost(reqs)
        if opt <= 0:
            return float("nan")
        self._last = actual / opt
        return self._last
