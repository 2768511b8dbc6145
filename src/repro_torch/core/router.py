"""KV-aware Smart Router — the mechanism of Game 3.

Per-worker cost (Dynamo Eq. 1):      c_j = ω·b_j^prefill + b_j^active
Worker selection (Eq. 2):            argmin (τ=0)  or  softmax(−c/τ) sample

``b_j^prefill`` — token blocks that would need prefilling on worker j
(total blocks − cached overlap, from the KvIndexer radix tree);
``b_j^active`` — active decode blocks on worker j (load proxy).

``best_worker`` accepts a per-request ``router_config_override`` — the hook
the paper's adaptive controller uses to switch (τ, ω) without restarts —
and a precomputed ``hashes`` memo so the request's block hashes are
computed once per request instead of once per router call.
The sequential greedy assignment this implements is best-response dynamics
in the routing congestion game (paper §4.3).

Large-pool fast path: for τ=0 pools of ``VECTORIZE_MIN_WORKERS`` or more,
the Eq. 1 argmin runs on a cached numpy load vector (rebuilt only when a
worker's load/health/capacity actually changes — ``WorkerState`` fields
are cache-invalidating properties) with elementwise operations in the
same order as the scalar loop, so results are bit-exact with the legacy
path while the per-decision cost drops from O(workers) Python arithmetic
to a handful of C-level vector ops."""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.radix import KvIndexer, block_hashes


@dataclass(frozen=True)
class KvRouterConfig:
    overlap_weight: float = 1.0        # ω (kv_overlap_score_weight)
    temperature: float = 0.0           # τ (router_temperature)
    # Overlap scorer: "exact" walks the KvIndexer radix tree; "simhash"
    # scores from the O(1) simhash-bucketed affinity index
    # (repro.core.affinity) — approximate, production-stack style.  The
    # choice is structural (made at router construction); per-request
    # adaptive (τ, ω) overrides do not switch scorers mid-run.
    affinity: str = "exact"            # exact | simhash
    affinity_prefix_blocks: int = 4    # simhash feature window (blocks)


class WorkerState:
    """Mutable routing-table entry.  ``active_blocks``/``healthy``/
    ``capacity`` are properties so a KvPushRouter can invalidate its
    cached dense load view whenever the value actually changes; a
    standalone WorkerState (baseline routers, tests) has no router
    backref and behaves like the plain record it used to be."""

    __slots__ = ("worker_id", "_active_blocks", "_healthy", "_capacity",
                 "_router")

    def __init__(self, worker_id: int, active_blocks: float = 0,
                 healthy: bool = True, capacity: float = 1.0):
        self.worker_id = worker_id
        self._active_blocks = active_blocks
        self._healthy = healthy
        self._capacity = capacity
        self._router: Optional["KvPushRouter"] = None

    def __repr__(self):
        return (f"WorkerState(worker_id={self.worker_id}, "
                f"active_blocks={self._active_blocks}, "
                f"healthy={self._healthy}, capacity={self._capacity})")

    @property
    def active_blocks(self):
        return self._active_blocks

    @active_blocks.setter
    def active_blocks(self, value):
        if value != self._active_blocks:
            self._active_blocks = value
            if self._router is not None:
                self._router._state_cache = None

    @property
    def healthy(self):
        return self._healthy

    @healthy.setter
    def healthy(self, value):
        if value != self._healthy:
            self._healthy = value
            if self._router is not None:
                self._router._state_cache = None

    @property
    def capacity(self):
        return self._capacity

    @capacity.setter
    def capacity(self, value):
        if value != self._capacity:
            self._capacity = value
            if self._router is not None:
                self._router._state_cache = None


class KvPushRouter:
    """The router core; mirrors Dynamo's Python handler semantics."""

    # Pools below this size route through the legacy scalar path — numpy
    # call overhead beats the vector win on the paper's 2–5 worker pools.
    VECTORIZE_MIN_WORKERS = 16

    def __init__(self, num_workers: int, config: Optional[KvRouterConfig] = None,
                 indexer: Optional[KvIndexer] = None, seed: int = 0):
        self.workers: Dict[int, WorkerState] = {}
        self.config = config or KvRouterConfig()
        self.indexer = indexer or KvIndexer()
        self._rng = random.Random(seed)
        self.vectorized = True
        # approximate overlap scorer (config.affinity="simhash"): replaces
        # the radix walk with a bucket lookup on both scoring paths
        self.affinity = None
        if self.config.affinity == "simhash":
            from repro_torch.core.affinity import SimHashAffinity
            self.affinity = SimHashAffinity(
                block_size=self.indexer.block_size,
                prefix_blocks=self.config.affinity_prefix_blocks,
                ttl=self.indexer.ttl)
        elif self.config.affinity != "exact":
            raise ValueError(
                f"unknown affinity {self.config.affinity!r}: "
                f"expected 'exact' or 'simhash'")
        # cached dense routing state:
        # (healthy ids, id→position, loads array, ids ascending?)
        self._state_cache: Optional[
            Tuple[List[int], Dict[int, int], np.ndarray, bool]] = None
        for i in range(num_workers):
            self._enlist(WorkerState(i))

    def _enlist(self, st: WorkerState) -> WorkerState:
        st._router = self
        self.workers[st.worker_id] = st
        self._state_cache = None
        return st

    # ------------------------------------------------------------- costs ----

    # Cache-affinity scale: how much active load (in request units) a full
    # prefix hit is worth in the Eq. 1 cost. Dynamo measures both terms in
    # blocks; we normalize b_active to request units and scale b_prefill so
    # ω=1 affinity competes with realistic load imbalances (calibration
    # liberty recorded in DESIGN.md).
    PREFILL_BLOCK_SCALE = 20.0

    def _normalized_load(self, ids: List[int]) -> List[float]:
        """b_j^active normalized by relative worker capacity.

        Heterogeneous pools (mixed-generation GPUs) expose different
        ``capacity`` values; the load proxy is rescaled so a worker at 50%
        of its slots competes equally regardless of absolute slot count.
        Homogeneous pools (all capacities equal) take the identity path —
        raw block counts — so legacy behavior is bit-exact.
        """
        caps = [self.workers[wid].capacity for wid in ids]
        if len(set(caps)) <= 1:
            return [float(self.workers[wid].active_blocks) for wid in ids]
        ref = sum(caps) / len(caps)
        return [self.workers[wid].active_blocks * (ref / cap)
                for wid, cap in zip(ids, caps)]

    def _dense_state(self) -> Tuple[List[int], Dict[int, int], np.ndarray,
                                    bool]:
        """Healthy ids, id→position map and numpy load vector, rebuilt only
        when some worker's load/health/capacity changed since the last
        decision (in the simulator that's the 1 s metric sync, not every
        request)."""
        cached = self._state_cache
        if cached is None:
            ids = self.healthy_ids()
            cached = self._state_cache = (
                ids,
                {wid: i for i, wid in enumerate(ids)},
                np.asarray(self._normalized_load(ids), dtype=np.float64),
                all(a < b for a, b in zip(ids, ids[1:])))
        return cached

    def costs(self, tokens: Sequence[int],
              config: Optional[KvRouterConfig] = None, now: float = 0.0,
              hashes: Optional[Sequence[int]] = None
              ) -> Tuple[List[int], List[float], List[float]]:
        """Returns (worker_ids, costs c_j, overlap fractions o_j)."""
        cfg = config or self.config
        ids = self.healthy_ids()
        scorer = self.affinity if self.affinity is not None else self.indexer
        overlaps = scorer.overlap_scores(tokens, ids, now, hashes=hashes)
        loads = self._normalized_load(ids)
        costs = []
        for ov, b_active in zip(overlaps, loads):
            b_prefill = self.PREFILL_BLOCK_SCALE * (1.0 - ov)
            costs.append(cfg.overlap_weight * b_prefill + b_active)
        return ids, costs, overlaps

    # ------------------------------------------------------------ select ----

    def best_worker(self, tokens: Sequence[int],
                    router_config_override: Optional[KvRouterConfig] = None,
                    now: float = 0.0,
                    hashes: Optional[Sequence[int]] = None
                    ) -> Tuple[int, float, List[float]]:
        """Returns (worker_id, overlap_score_of_chosen, overlap_per_worker).

        τ=0: deterministic argmin (Eq. 2 limit). τ>0: softmax over costs
        normalized by their spread (Dynamo's τ∈[0,1] operates on normalized
        costs; raw block counts would make any τ≤1 effectively greedy)."""
        cfg = router_config_override or self.config
        if (self.vectorized
                and (self.affinity is not None or self.indexer.aggregated)
                and cfg.temperature <= 0.0
                and len(self.workers) >= self.VECTORIZE_MIN_WORKERS):
            return self._best_worker_vectorized(tokens, cfg, now, hashes)
        ids, costs, overlaps = self.costs(tokens, cfg, now, hashes=hashes)
        if not ids:
            raise RuntimeError("no healthy workers")
        if cfg.temperature <= 0.0 or len(ids) == 1:
            j = min(range(len(ids)), key=lambda i: (costs[i], ids[i]))
        else:
            mn = min(costs)
            spread = max(max(costs) - mn, 1e-9)
            z = [(c - mn) / spread for c in costs]          # ∈ [0, 1]
            ws = [math.exp(-zi / cfg.temperature) for zi in z]
            tot = sum(ws)
            r = self._rng.random() * tot
            acc = 0.0
            j = len(ids) - 1
            for i, w in enumerate(ws):
                acc += w
                if r <= acc:
                    j = i
                    break
        return ids[j], overlaps[j], overlaps

    def _best_worker_vectorized(self, tokens: Sequence[int],
                                cfg: KvRouterConfig, now: float,
                                hashes: Optional[Sequence[int]]
                                ) -> Tuple[int, float, List[float]]:
        """τ=0 argmin on the cached load vector.  The sparse aggregated
        walk yields only the warm workers; the dense overlap vector is
        filled in C.  Elementwise operations run in the exact order of the
        scalar loop (1−o, ×scale, ×ω, +load) and ties go to the smallest
        worker id, so the choice is bit-exact with the legacy path."""
        ids, pos, loads, ids_sorted = self._dense_state()
        if not ids:
            raise RuntimeError("no healthy workers")
        if hashes is None:
            hashes = block_hashes(tokens, self.indexer.block_size)
        total = max(len(hashes), 1)
        ov = np.zeros(len(ids))
        depths = (self.affinity.overlap_depths(hashes, now)
                  if self.affinity is not None
                  else self.indexer.overlap_depths(hashes, now))
        for w, d in depths.items():
            i = pos.get(w)
            if i is not None:
                ov[i] = d / total
        cost = 1.0 - ov
        cost *= self.PREFILL_BLOCK_SCALE
        cost *= cfg.overlap_weight
        cost += loads
        if ids_sorted:
            # np.argmin returns the first minimum; positions ascend with
            # worker id, so this IS the (cost, id) tie-break
            j = int(np.argmin(cost))
        else:
            ties = np.flatnonzero(cost == cost.min())
            j = int(min(ties, key=lambda i: ids[i]))
        return ids[j], float(ov[j]), ov.tolist()

    # --------------------------------------------------------- bookkeeping --

    def cache_coherent(self) -> Optional[str]:
        """Audit hook (``repro.analysis.sanitize``): compare the cached
        dense routing state against a fresh recompute from the worker
        table.  Returns ``None`` when coherent (or when no cache is
        live), else a description of the divergence.  Pure read — never
        rebuilds or invalidates the cache."""
        cached = self._state_cache
        if cached is None:
            return None
        ids, pos, loads, ids_sorted = cached
        fresh_ids = [w for w, st in self.workers.items() if st.healthy]
        if ids != fresh_ids:
            return (f"cached healthy ids {ids} != recomputed {fresh_ids} "
                    f"(a health change bypassed the property setter)")
        if pos != {wid: i for i, wid in enumerate(fresh_ids)}:
            return f"cached id->position map {pos} inconsistent with {ids}"
        fresh = np.asarray(self._normalized_load(fresh_ids), dtype=np.float64)
        if loads.shape != fresh.shape or not np.array_equal(loads, fresh):
            return (f"cached load vector {loads.tolist()} != recomputed "
                    f"{fresh.tolist()} (a load/capacity write bypassed the "
                    f"property setter)")
        if ids_sorted != all(a < b for a, b in zip(ids, ids[1:])):
            return f"cached ids-sorted flag {ids_sorted} wrong for {ids}"
        return None

    def healthy_ids(self) -> List[int]:
        """Worker ids eligible for routing, in the table's stable order —
        the positional universe of ``costs()``/``best_worker()`` overlaps.
        Served from the dense-state cache when valid (any health change
        invalidates it), so per-request callers don't rescan the table.
        Always a fresh list: the cache's own list must never be aliased
        to callers that might mutate it."""
        cached = self._state_cache
        if cached is not None:
            return list(cached[0])
        return [w for w, st in self.workers.items() if st.healthy]

    def add_worker(self, worker_id: int, capacity: float = 1.0) -> WorkerState:
        """(Re-)enlist a worker in the routing table with a clean load view
        — the Game 1 repartitioning path when a prefill-role worker flips
        into the decode pool.  Re-enlisting an id that drained out earlier
        reuses its table slot (keeping positional order stable)."""
        st = self.workers.get(worker_id)
        if st is None:
            st = self._enlist(WorkerState(worker_id))
        st.healthy = True
        st.active_blocks = 0
        st.capacity = max(capacity, 1e-9)
        if self.affinity is not None:
            # a flipped-in worker is cache-cold; stale bucket credit from
            # its previous decode stint must not survive the flip
            self.affinity.clear_worker(worker_id)
        self._state_cache = None
        return st

    def on_schedule(self, worker_id: int, tokens: Sequence[int],
                    decode_blocks: float = 1.0, now: float = 0.0,
                    hashes: Optional[Sequence[int]] = None):
        """Request placed: bump the load proxy and index its KV blocks."""
        st = self.workers[worker_id]
        st.active_blocks += decode_blocks
        if hashes is None and self.affinity is not None:
            hashes = block_hashes(tokens, self.indexer.block_size)
        self.indexer.insert(worker_id, tokens, now, hashes=hashes)
        if self.affinity is not None:
            self.affinity.insert(worker_id, hashes, now)

    def on_complete(self, worker_id: int, tokens: Sequence[int],
                    decode_blocks: float = 1.0):
        st = self.workers[worker_id]
        st.active_blocks = max(st.active_blocks - decode_blocks, 0.0)

    def set_health(self, worker_id: int, healthy: bool):
        self.workers[worker_id].healthy = healthy

    def set_capacity(self, worker_id: int, capacity: float):
        """Declare a worker's relative decode capacity (heterogeneity)."""
        self.workers[worker_id].capacity = max(capacity, 1e-9)


# ------------------------------------------------------ static baselines ----
#
# Every baseline implements the same ``best_worker(tokens,
# router_config_override=None, now=0.0, hashes=None)`` signature as
# KvPushRouter, so routing policies are drop-in interchangeable, and all of
# them skip unhealthy workers (routing to a dead worker is not a baseline,
# it's a bug).  Built from an int they keep a standalone all-healthy worker
# table; built from a KvPushRouter they share its table, so
# ``set_health`` on the router is visible to the baseline.


class _BaselineRouter:
    def __init__(self, workers):
        if isinstance(workers, KvPushRouter):
            self._table = workers.workers
        else:
            self._table = {i: WorkerState(i) for i in range(int(workers))}

    def _healthy_ids(self) -> List[int]:
        ids = [w for w, st in self._table.items() if st.healthy]
        if not ids:
            raise RuntimeError("no healthy workers")
        return ids

    def set_health(self, worker_id: int, healthy: bool):
        self._table[worker_id].healthy = healthy


class RoundRobinRouter(_BaselineRouter):
    """§9.2 counterfactual baseline: cycle over the healthy workers."""

    def __init__(self, workers):
        super().__init__(workers)
        self._i = 0

    def best_worker(self, tokens, router_config_override=None, now=0.0,
                    hashes=None):
        ids = self._healthy_ids()
        w = ids[self._i % len(ids)]
        self._i += 1
        return w, 0.0, [0.0] * len(ids)


class RandomRouter(_BaselineRouter):
    def __init__(self, workers, seed: int = 0):
        super().__init__(workers)
        self._rng = random.Random(seed)

    def best_worker(self, tokens, router_config_override=None, now=0.0,
                    hashes=None):
        ids = self._healthy_ids()
        return ids[self._rng.randrange(len(ids))], 0.0, [0.0] * len(ids)


class PowerOfTwoRouter(_BaselineRouter):
    """Pick two random workers, route to the less loaded (§9.2 baseline)."""

    def __init__(self, router: KvPushRouter, seed: int = 0):
        super().__init__(router)
        self.router = router
        self._rng = random.Random(seed)

    def best_worker(self, tokens, router_config_override=None, now=0.0,
                    hashes=None):
        ids = self._healthy_ids()
        a, b = self._rng.sample(ids, 2) if len(ids) >= 2 else (ids[0], ids[0])
        # compare capacity-normalized utilization so heterogeneous pools
        # don't starve the small workers (ties break to the first pick)
        wa = (self.router.workers[a].active_blocks
              / self.router.workers[a].capacity)
        wb = (self.router.workers[b].active_blocks
              / self.router.workers[b].capacity)
        w = a if wa <= wb else b
        return w, 0.0, [0.0] * len(ids)
