"""Shared serving control plane — one runtime driving both backends.

The paper's mechanisms (Smart Router Eq. 1/2 + KvIndexer radix tree,
saturation detector Eq. 10/11, Table 2 adaptive regime params +
dual-frontend switch, Planner, PoA tracker Eq. 12, metrics registry) are
backend-agnostic: they consume routing-time token/hash streams and
telemetry, not simulated or real compute.  :class:`ControlPlane` owns that
wiring once, and two *backends* drive it:

* the **analytic backend** — :class:`repro.serving.simulator.Simulator`,
  the event-driven latency-model cluster (all calibrated experiments);
* the **engine backend** — :class:`repro.serving.disagg.DisaggregatedCluster`
  over real jitted-JAX :class:`~repro.serving.engine.PrefillEngine` /
  :class:`~repro.serving.engine.DecodeEngine` workers, where a cache-warm
  routing decision actually skips prefill recomputation.

Both backends route through :meth:`select_worker`, so a routing decision is
computed by the *same* code path given the same (tokens, hashes, indexer
state, load view) — that is what makes backend parity a testable property
(``tests/test_backend_parity.py``, ``benchmarks/bench_backend_parity.py``).

``decision_log`` (opt-in) records every routing decision for parity
comparison; it is off by default so large analytic runs carry no extra
per-request state, and it is a bounded deque when a backend passes
``decision_log_maxlen`` (parity scenarios keep ``None`` — they must see
every placement).

Replicated control plane (production scale-out): every read a routing
decision consumes — load vector, overlap scores, healthy set, detector
regime — goes through an explicit :class:`StateView`.  The single-router
path uses the fresh pass-through view (zero-copy, bit-exact with direct
access); :class:`ReplicatedControlPlane` runs R router replicas, each
against its own :class:`ReplicaStateView` — a frozen snapshot of the
authoritative state refreshed on the backend's event-clock sync cadence,
plus the replica's *own* placements since the last sync (a replica sees
its own writes immediately, everyone else's only at sync — the
eventual-consistency model of multi-replica router deployments).  Writes
(claims, load bumps, drains, plan flips) still serialize through the one
authoritative router/indexer store, and replica conflicts — a stale view
placing onto a worker that is gone or already at capacity — reconcile at
the admission write, not at routing.
"""
from __future__ import annotations

import math
import random
import time
from collections import deque
from dataclasses import replace
from typing import (Deque, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

from repro_torch.core.radix import block_hashes

from repro_torch.core.controller import (REGIME_PARAMS, DualFrontend,
                                   export_game_metrics)
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.planner import Planner, PlannerConfig
from repro_torch.core.poa import PoATracker
from repro_torch.core.router import (KvPushRouter, KvRouterConfig, PowerOfTwoRouter,
                               RandomRouter, RoundRobinRouter)
from repro_torch.core.saturation import DetectorConfig, Regime, SaturationDetector
from repro_torch.serving.fabric import transfer_block_count


def _net_argmin(fabric, cfg, ids, overlaps, loads, total_blocks, now, rng):
    """Network-aware Eq. 1: the cache-affinity cost plus each candidate's
    *effective* transfer time quoted from current link queue depths —
    decode selection as congestion avoidance (the NetKV term).

    ``fabric`` may be the live :class:`~repro.serving.fabric.Fabric` (fresh
    view) or a frozen :class:`~repro.serving.fabric.FabricSnapshot`
    (replica view) — both expose ``route_src``/``quote``/``config``."""
    scale = KvPushRouter.PREFILL_BLOCK_SCALE
    weight = fabric.config.net_weight
    src = fabric.route_src(now)
    costs = []
    for ov, ld, w in zip(overlaps, loads, ids):
        blocks = transfer_block_count(total_blocks, ov)
        costs.append(cfg.overlap_weight * (scale * (1.0 - ov)) + ld
                     + weight * fabric.quote(src, w, blocks, now))
    if cfg.temperature <= 0.0 or len(ids) == 1:
        j = min(range(len(ids)), key=lambda i: (costs[i], ids[i]))
    else:
        mn = min(costs)
        spread = max(max(costs) - mn, 1e-9)
        z = [(c - mn) / spread for c in costs]
        ws = [math.exp(-zi / cfg.temperature) for zi in z]
        tot = sum(ws)
        r = rng.random() * tot
        acc = 0.0
        j = len(ids) - 1
        for i, w in enumerate(ws):
            acc += w
            if r <= acc:
                j = i
                break
    return ids[j], overlaps[j], overlaps


class RoutingDecision(NamedTuple):
    """One logged routing decision (parity comparisons key on these)."""
    rid: object            # backend request id (int rid / str request_id)
    worker: int
    overlap: float
    now: float


class StateView:
    """Fresh pass-through view of the control plane's routing state.

    Every read :meth:`ControlPlane.select_worker` performs goes through a
    view — this one delegates verbatim to the live authoritative objects,
    so the single-router path stays bit-exact with direct access while
    sharing one read interface with the bounded-staleness
    :class:`ReplicaStateView`."""

    def __init__(self, plane: "ControlPlane"):
        self._plane = plane

    @property
    def regime(self):
        return self._plane.detector.regime

    def age(self, now: float) -> float:
        return 0.0

    def healthy_ids(self) -> List[int]:
        return self._plane.router.healthy_ids()

    def overlap_scores(self, tokens: Sequence[int], ids: Sequence[int],
                       now: float,
                       hashes: Optional[Sequence[int]] = None) -> List[float]:
        return self._plane.router.indexer.overlap_scores(
            tokens, ids, now, hashes=hashes)

    def best_worker(self, tokens: Sequence[int], cfg, now: float,
                    hashes: Optional[Sequence[int]]
                    ) -> Tuple[int, float, List[float]]:
        return self._plane.policy.best_worker(
            tokens, router_config_override=cfg, now=now, hashes=hashes)

    def net_best_worker(self, tokens: Sequence[int], cfg, now: float,
                        hashes: Optional[Sequence[int]]
                        ) -> Tuple[int, float, List[float]]:
        """Network-aware selection against live link state (fresh view)."""
        plane = self._plane
        router = plane.router
        ids = router.healthy_ids()
        overlaps = self.overlap_scores(tokens, ids, now, hashes=hashes)
        caps = [router.workers[w].capacity for w in ids]
        if len(set(caps)) <= 1:
            loads = [float(router.workers[w].active_blocks) for w in ids]
        else:       # capacity-normalized, mirroring _normalized_load
            ref = sum(caps) / len(caps)
            loads = [router.workers[w].active_blocks * (ref / cap)
                     for w, cap in zip(ids, caps)]
        total = len(hashes) if hashes is not None else len(
            block_hashes(tokens))
        return _net_argmin(plane.fabric, cfg, ids, overlaps, loads, total,
                           now, plane._net_rng)


class ReplicaStateView(StateView):
    """Bounded-staleness replica view: a frozen snapshot of the
    authoritative routing state (healthy set, load vector, regime,
    fresh indexer claims) taken at :meth:`sync`, plus a local delta of
    the placements *this replica* routed since — KV events stream to the
    replica that issued them immediately, while everyone else's claims
    and all load telemetry arrive only at the next sync.

    Scoring mirrors the router's Eq. 1 arithmetic against the snapshot:
    ``cost = ω · PREFILL_BLOCK_SCALE · (1 − overlap) + load`` with the
    (cost, worker-id) tie-break at τ=0 and the spread-normalized softmax
    sample (per-replica seeded RNG) at τ>0.

    Every read method here works only off ``self`` snapshot fields —
    authoritative reads are confined to :meth:`sync` (lint rule RA011
    enforces this repo-wide for ``Replica*View`` classes)."""

    def __init__(self, plane: "ControlPlane", index: int, bound: float,
                 seed: int = 0):
        super().__init__(plane)
        self.index = index
        self.bound = bound                 # max allowed age (backend clock)
        self.synced_at: Optional[float] = None
        self._rng = random.Random((seed + 1) * 7919 + index)
        self._ids: List[int] = []
        self._loads: List[float] = []
        self._regime = None
        # base snapshot: block hash → workers with a fresh claim at sync
        self._hash_claims: Dict[int, Tuple[int, ...]] = {}
        # local delta: block hash → workers this replica placed since sync
        self._local_claims: Dict[int, List[int]] = {}
        # frozen fabric link state (None when the plane has no fabric)
        self._fabric = None

    # ------------------------------------------------------------- sync ----

    def sync(self, now: float) -> None:
        """Refresh the snapshot from the authoritative store.  The ONLY
        method allowed to read the plane's mutable state."""
        plane = self._plane
        router = plane.router
        ids = router.healthy_ids()
        caps = [router.workers[w].capacity for w in ids]
        if len(set(caps)) <= 1:
            loads = [float(router.workers[w].active_blocks) for w in ids]
        else:      # capacity-normalized, mirroring _normalized_load
            ref = sum(caps) / len(caps)
            loads = [router.workers[w].active_blocks * (ref / cap)
                     for w, cap in zip(ids, caps)]
        self._ids = ids
        self._loads = loads
        self._regime = plane.detector.regime
        self._hash_claims = router.indexer.snapshot_claims(now)
        self._local_claims = {}
        fabric = plane.fabric
        self._fabric = fabric.freeze() if fabric is not None else None
        self.synced_at = now

    def frozen_state(self):
        """Deep-frozen copy of the base snapshot (NOT the local delta) —
        the sanitizer records one per sync and asserts nothing but
        :meth:`sync` ever rewrites it."""
        base = (self.synced_at, tuple(self._ids), tuple(self._loads),
                self._regime,
                tuple(sorted((h, ws) for h, ws in self._hash_claims.items())))
        if self._fabric is not None:
            return base + (self._fabric.state_key(),)
        return base

    # ------------------------------------------------------------- reads ----

    @property
    def regime(self):
        return self._regime

    def age(self, now: float) -> float:
        if self.synced_at is None:
            return math.inf
        return now - self.synced_at

    def healthy_ids(self) -> List[int]:
        return list(self._ids)

    def overlap_depths(self, hashes: Sequence[int]) -> Dict[int, int]:
        """Fresh contiguous prefix depth per worker against the snapshot
        claims ∪ this replica's local placements — same walk semantics as
        ``KvIndexer.overlap_depths``, no tree access, no TTL sweep."""
        depth: Dict[int, int] = {}
        get = depth.get
        i = 0
        for h in hashes:
            base = self._hash_claims.get(h, ())
            local = self._local_claims.get(h, ())
            advanced = 0
            for w in base:
                if get(w, 0) == i:
                    depth[w] = i + 1
                    advanced += 1
            for w in local:
                if get(w, 0) == i:
                    depth[w] = i + 1
                    advanced += 1
            if not advanced:
                break
            i += 1
        return depth

    def overlap_scores(self, tokens: Sequence[int], ids: Sequence[int],
                       now: float,
                       hashes: Optional[Sequence[int]] = None) -> List[float]:
        hs = list(hashes) if hashes is not None else block_hashes(tokens)
        total = max(len(hs), 1)
        depth = self.overlap_depths(hs)
        return [depth.get(w, 0) / total for w in ids]

    def best_worker(self, tokens: Sequence[int], cfg, now: float,
                    hashes: Optional[Sequence[int]]
                    ) -> Tuple[int, float, List[float]]:
        ids = self._ids
        if not ids:
            raise RuntimeError(f"replica {self.index}: no healthy workers "
                               f"in view")
        scale = KvPushRouter.PREFILL_BLOCK_SCALE   # class constant, not state
        overlaps = self.overlap_scores(tokens, ids, now, hashes=hashes)
        costs = [cfg.overlap_weight * (scale * (1.0 - ov)) + ld
                 for ov, ld in zip(overlaps, self._loads)]
        if cfg.temperature <= 0.0 or len(ids) == 1:
            j = min(range(len(ids)), key=lambda i: (costs[i], ids[i]))
        else:
            mn = min(costs)
            spread = max(max(costs) - mn, 1e-9)
            z = [(c - mn) / spread for c in costs]
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

    def net_best_worker(self, tokens: Sequence[int], cfg, now: float,
                        hashes: Optional[Sequence[int]]
                        ) -> Tuple[int, float, List[float]]:
        """Network-aware selection against the *frozen* fabric snapshot
        taken at the last sync — a replica quotes link queues exactly as
        stale as the rest of its world (no authoritative reads here)."""
        ids = self._ids
        if not ids:
            raise RuntimeError(f"replica {self.index}: no healthy workers "
                               f"in view")
        overlaps = self.overlap_scores(tokens, ids, now, hashes=hashes)
        total = len(hashes) if hashes is not None else len(
            block_hashes(tokens))
        return _net_argmin(self._fabric, cfg, ids, overlaps, self._loads,
                           total, now, self._rng)

    # ------------------------------------------------------------ writes ----

    def note_placement(self, worker: int, hashes: Optional[Sequence[int]]
                       ) -> None:
        """Record this replica's own placement in the local delta (its KV
        events are visible to itself immediately, to peers at sync)."""
        for h in hashes or ():
            ws = self._local_claims.get(h)
            if ws is None:
                self._local_claims[h] = [worker]
            elif worker not in ws:
                ws.append(worker)


class ControlPlane:
    """Router + indexer + detector + adaptive params + Planner + PoA +
    metrics, wired once and shared by the analytic and engine backends."""

    def __init__(self, num_workers: int, *,
                 router_config: Optional[KvRouterConfig] = None,
                 routing_policy: str = "kv",    # kv|round_robin|random|p2c
                 seed: int = 0,
                 adaptive: bool = False,
                 detector_config: Optional[DetectorConfig] = None,
                 regime_params: Optional[Dict] = None,
                 cache_ttl: Optional[float] = None,
                 capacities: Optional[Mapping[int, float]] = None,
                 poa_num_workers: Optional[int] = None,
                 poa_window_s: float = 30.0,
                 poa_window_count: Optional[int] = None,
                 poa_capacities: Sequence[float] = (),
                 planner_config: Optional[PlannerConfig] = None,
                 num_prefill: int = 0,
                 log_decisions: bool = False,
                 decision_log_maxlen: Optional[int] = None,
                 fabric=None,                   # repro.serving.fabric.Fabric
                 network_aware: bool = False,
                 sanitize: Optional[bool] = None):
        # Fourth game: an attached Fabric prices P→D transfers on shared
        # links; network_aware additionally folds each candidate's quoted
        # transfer time into the routing cost (requires the kv policy —
        # baselines carry no per-candidate cost vector to extend).
        self.fabric = fabric
        self.network_aware = bool(network_aware and fabric is not None)
        if self.network_aware and routing_policy != "kv":
            raise ValueError(
                "network_aware selection requires routing_policy='kv' "
                f"(got {routing_policy!r})")
        self._net_rng = random.Random((seed + 1) * 104729)
        self.router = KvPushRouter(num_workers,
                                   router_config or KvRouterConfig(),
                                   seed=seed)
        if cache_ttl is not None:
            self.router.indexer.ttl = cache_ttl
            if self.router.affinity is not None:
                self.router.affinity.ttl = cache_ttl
        if capacities:
            for wid, cap in capacities.items():
                self.router.set_capacity(wid, cap)
        # Baselines share the router's worker table so health changes
        # propagate to every policy.
        self.routing_policy = routing_policy
        if routing_policy == "round_robin":
            self.policy = RoundRobinRouter(self.router)
        elif routing_policy == "random":
            self.policy = RandomRouter(self.router, seed)
        elif routing_policy == "p2c":
            self.policy = PowerOfTwoRouter(self.router, seed)
        else:
            self.policy = self.router

        self.adaptive = adaptive
        self.detector = SaturationDetector(detector_config or DetectorConfig())
        self.dual = DualFrontend()
        self.regime_params = dict(regime_params or REGIME_PARAMS)
        self.metrics = MetricsRegistry()
        self.switch_time: Optional[float] = None

        # Game 1: the Planner joins the control plane when configured.
        self.planner: Optional[Planner] = None
        self.planner_config: Optional[PlannerConfig] = None
        if planner_config is not None:
            self.planner_config = replace(
                planner_config, total_workers=num_workers + num_prefill)
            self.planner = Planner(config=self.planner_config,
                                   prefill_workers=num_prefill,
                                   decode_workers=num_workers)

        poa_kw = dict(num_workers=poa_num_workers or num_workers,
                      window_s=poa_window_s, capacities=tuple(poa_capacities))
        if poa_window_count is not None:
            poa_kw["window_count"] = poa_window_count
        self.poa = PoATracker(**poa_kw)

        self.log_decisions = log_decisions
        # Bounded by default-None: parity harnesses need every placement,
        # but 100k-request scale runs that turn logging on would otherwise
        # grow this without bound.
        self.decision_log: Deque[RoutingDecision] = \
            deque(maxlen=decision_log_maxlen)
        self._last_config: KvRouterConfig = self.router.config
        # every routing-time read goes through a StateView (the fresh
        # pass-through one here; ReplicatedControlPlane routes replicas
        # against bounded-staleness snapshots instead)
        self.view = StateView(self)

        # Opt-in coherence sanitizer for bare control-plane users; the
        # backends pass sanitize=False here and attach their own richer
        # sanitizers over this plane's structures.
        self.sanitizer = None
        if sanitize:
            raise NotImplementedError(
                "the coherence sanitizer is not ported yet (ROADMAP.md, "
                "queue item 'port sanitizer')")

    # ------------------------------------------------------------ params ----

    def active_router_config(self, now: float) -> KvRouterConfig:
        """Table 2 regime-gated (τ, ω) override (plus the §6.4 dual-frontend
        switch bookkeeping); static config when not adaptive."""
        if not self.adaptive:
            return self.router.config
        regime = self.view.regime
        self.dual.on_regime(regime, now)
        if self.dual.active_port == 8001 and self.switch_time is None:
            self.switch_time = self.dual.switch_time
        return self.regime_params.get(regime) or self.router.config

    # ----------------------------------------------------------- routing ----

    def select_worker(self, tokens: Sequence[int], *,
                      hashes: Optional[Sequence[int]] = None,
                      now: float = 0.0,
                      live_ids: Optional[Sequence[int]] = None,
                      rid: object = None, record: bool = True
                      ) -> Tuple[int, float, List[float], List[int]]:
        """One routing decision through the active policy.

        Returns ``(worker, overlap, overlaps, ids)`` where ``overlaps`` is
        positionally aligned with ``ids``.  Baseline policies (round-robin /
        random / p2c) report no overlap themselves, so their overlap vector
        is re-scored from the indexer over ``live_ids`` (the backend's live
        decode set) — the counterfactual the PoA tracker prices.

        ``record=False`` keeps the decision out of ``decision_log`` — for
        callers that may abandon the route (engine backpressure retries)
        and log only the placement that actually happened via
        :meth:`log_decision`.
        """
        cfg = self._last_config = self.active_router_config(now)
        view = self.view
        if self.network_aware:
            worker, overlap, overlaps = view.net_best_worker(
                tokens, cfg, now, hashes=hashes)
        else:
            worker, overlap, overlaps = view.best_worker(tokens, cfg, now,
                                                         hashes=hashes)
        if self.policy is not self.router:
            ids = (list(live_ids) if live_ids is not None
                   else view.healthy_ids())
            overlaps = view.overlap_scores(tokens, ids, now, hashes=hashes)
            overlap = overlaps[ids.index(worker)]
        else:
            ids = view.healthy_ids()
        if record:
            self.log_decision(rid, worker, overlap, now)
        return worker, overlap, overlaps, ids

    def log_decision(self, rid: object, worker: int, overlap: float,
                     now: float) -> None:
        if self.log_decisions:
            self.decision_log.append(
                RoutingDecision(rid, worker, overlap, now))

    def route(self, tokens: Sequence[int], *,
              hashes: Optional[Sequence[int]] = None,
              now: float = 0.0,
              live_ids: Optional[Sequence[int]] = None,
              rid: object = None, record: bool = True
              ) -> Tuple[int, float, List[float], List[int]]:
        """Engine-path routing: :meth:`select_worker` plus the Algorithm 1
        Prometheus exports (game_poa, game_saturation_state,
        game_router_temperature, game_overlap_weight, game_routing_cost)."""
        t0 = time.perf_counter()
        worker, overlap, overlaps, ids = self.select_worker(
            tokens, hashes=hashes, now=now, live_ids=live_ids, rid=rid,
            record=record)
        dt = time.perf_counter() - t0
        export_game_metrics(self.metrics, regime=self.detector.regime,
                            config=self._last_config, decision_s=dt,
                            now=now, poa_tracker=self.poa)
        return worker, overlap, overlaps, ids

    # --------------------------------------------------------- telemetry ----

    def observe(self, ttft_p99: float, now: float) -> Regime:
        """Feed one polled TTFT P99 sample to the saturation detector."""
        return self.detector.observe(ttft_p99, now)

    def regime_transitions(self) -> List[Tuple[float, int, int]]:
        """(t, from, to) regime transitions — the parity observable."""
        return list(self.detector.transitions)


class ReplicatedControlPlane(ControlPlane):
    """R router replicas over bounded-staleness :class:`ReplicaStateView`s.

    Requests are assigned to replicas deterministically (round-robin on
    the decision counter); each replica routes against its own view,
    refreshed when the backend calls :meth:`sync_views` on its event-clock
    sync cadence.  Writes still serialize through the single authoritative
    store (``self.router``/``self.poa``/…), and the write path resolves
    replica conflicts at admission — routing itself never blocks on fresh
    state.  Two cases reconcile:

    * the stale view placed onto a worker that has since left the healthy
      set (drain/flip): the write cannot land, the fresh choice is taken;
    * replicas piled onto the same near-full worker within one sync
      window: the admission ledger (:attr:`_window_writes`, reset at each
      sync) accepts serialized placements until running occupancy plus
      in-window writes exceed ``ADMIT_QUEUE_FACTOR ×`` the worker's
      declared capacity — a bounded admission queue — and redirects the
      overflow to the fresh choice.

    The ledger threshold matters for what the staleness sweep measures:
    stale herding onto a visibly busy worker is *legal* (it queues — that
    queueing delay IS the staleness externality PoA-hat prices); only the
    unbounded pile-up a real admission controller would refuse gets
    reconciled.

    ``staleness_s = 0`` keeps every replica on the fresh pass-through
    view: routing is bit-exact with the single-router :class:`ControlPlane`
    for any R (the refactor pin), at zero extra scoring cost.

    With ``staleness_s > 0`` every decision also runs the authoritative
    fresh-state scorer — that is what the returned ``(overlap, overlaps)``
    report, so backend physics (prefill discount, tier split, transfer
    charge) and the PoA tracker's counterfactual columns price the *real*
    cache/load state and PoA-hat isolates the staleness externality
    instead of compounding it with phantom-overlap accounting.  The
    fresh pass doubles as the routing-agreement probe
    (``agreement_rate``) and the conflict-resolution fallback."""

    # Admission-ledger queue bound: a worker accepts serialized placements
    # until running occupancy + in-window writes reach this multiple of
    # its declared capacity (one extra capacity-worth of queued work);
    # beyond that, placements reconcile to the fresh choice.
    ADMIT_QUEUE_FACTOR = 2.0

    def __init__(self, num_workers: int, *, replicas: int = 1,
                 staleness_s: float = 0.0, seed: int = 0, **kw):
        super().__init__(num_workers, seed=seed, **kw)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if staleness_s > 0 and self.routing_policy != "kv":
            raise ValueError(
                "stale replica views require routing_policy='kv' "
                f"(got {self.routing_policy!r}): baseline policies carry "
                "per-policy mutable state a frozen snapshot cannot replay")
        self.num_replicas = replicas
        self.staleness_s = staleness_s
        self.replica_logs: List[List[RoutingDecision]] = \
            [[] for _ in range(replicas)]
        self.decisions_total = 0
        self.agree_fresh = 0
        self.conflicts = 0
        # serialized admission ledger: worker → placements since the last
        # sync (the write-write conflict window)
        self._window_writes: Dict[int, int] = {}
        # staleness 0 → no snapshots at all: every replica routes on the
        # fresh pass-through view (identity path, nothing to sync)
        self.replica_views: List[ReplicaStateView] = []
        if staleness_s > 0:
            self.replica_views = [
                ReplicaStateView(self, i, staleness_s, seed=seed)
                for i in range(replicas)]
            self.sync_views(0.0)

    # ------------------------------------------------------------- views ----

    def sync_views(self, now: float) -> None:
        """Event-clock sync point: refresh every replica's snapshot from
        the authoritative store (no-op at staleness 0)."""
        for v in self.replica_views:
            v.sync(now)
        self._window_writes = {}

    @property
    def agreement_rate(self) -> float:
        """Fraction of decisions where the replica's stale-view choice
        matched the fresh-state choice."""
        return self.agree_fresh / max(self.decisions_total, 1)

    # ----------------------------------------------------------- routing ----

    def select_worker(self, tokens: Sequence[int], *,
                      hashes: Optional[Sequence[int]] = None,
                      now: float = 0.0,
                      live_ids: Optional[Sequence[int]] = None,
                      rid: object = None, record: bool = True
                      ) -> Tuple[int, float, List[float], List[int]]:
        r = self.decisions_total % self.num_replicas
        self.decisions_total += 1
        if not self.replica_views:
            # staleness 0: fresh views — the single-router path verbatim
            out = super().select_worker(tokens, hashes=hashes, now=now,
                                        live_ids=live_ids, rid=rid,
                                        record=record)
            self.agree_fresh += 1
            self.replica_logs[r].append(
                RoutingDecision(rid, out[0], out[1], now))
            return out

        view = self.replica_views[r]
        cfg = self._last_config = self.active_router_config(now)
        # adaptive regimes are read through the view too: a replica plays
        # the (τ, ω) of the regime it *believes* the cluster is in
        vcfg = cfg if not self.adaptive else (
            self.regime_params.get(view.regime) or self.router.config)
        if self.network_aware:
            stale_w, stale_ov, _ = view.net_best_worker(tokens, vcfg, now,
                                                        hashes=hashes)
        else:
            stale_w, stale_ov, _ = view.best_worker(tokens, vcfg, now,
                                                    hashes=hashes)
        view.note_placement(stale_w, hashes)
        self.replica_logs[r].append(
            RoutingDecision(rid, stale_w, stale_ov, now))

        # authoritative fresh pass: agreement probe + PoA counterfactual
        # vector + the state the serialized admission write checks
        if self.network_aware:
            fresh_w, _fresh_ov, overlaps = self.view.net_best_worker(
                tokens, cfg, now, hashes=hashes)
        else:
            fresh_w, _fresh_ov, overlaps = self.policy.best_worker(
                tokens, router_config_override=cfg, now=now, hashes=hashes)
        ids = self.router.healthy_ids()
        if fresh_w == stale_w:
            self.agree_fresh += 1
        worker = stale_w
        st = self.router.workers.get(stale_w)
        if st is None or not st.healthy:
            # the worker left the pool (drain/flip) after the last sync:
            # the write cannot land — take the fresh choice
            self.conflicts += 1
            worker = fresh_w
        elif fresh_w != stale_w:
            # contested placement: the stale view herded somewhere fresh
            # state would not.  The admission ledger lets contested writes
            # land (and queue — that delay IS the staleness externality)
            # until occupancy + contested-in-window writes exhaust the
            # bounded admission queue; only the pile-up beyond that
            # reconciles to the fresh choice, at admission, not at routing.
            if (st.capacity > 1.0
                    and st.active_blocks
                    + self._window_writes.get(stale_w, 0)
                    >= self.ADMIT_QUEUE_FACTOR * st.capacity):
                self.conflicts += 1
                worker = fresh_w
            else:
                self._window_writes[stale_w] = \
                    self._window_writes.get(stale_w, 0) + 1
        overlap = overlaps[ids.index(worker)]
        if record:
            self.log_decision(rid, worker, overlap, now)
        return worker, overlap, overlaps, ids
