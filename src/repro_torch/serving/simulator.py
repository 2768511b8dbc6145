"""Discrete-event simulator of a disaggregated serving cluster.

Faithfully wires together the paper's mechanisms — Smart Router (Eq. 1/2),
KvIndexer radix tree, KVBM frequency eviction, PoA tracker (Eq. 12),
saturation detector (Eq. 10/11), adaptive controller (Table 2), Planner —
around an event-driven cluster model with the paper's causal channels:

* requests are routed to a decode worker **at arrival** (Dynamo semantics);
* prefill is the compute-bound bottleneck; prefill work per request shrinks
  with the chosen decode worker's KV overlap (cache-warm routing skips
  recomputation — the §8.4 "redundant prefill recomputation" channel), so
  cache-oblivious spreading costs throughput;
* each decode worker has an admission cap (transfer/batch slots); requests
  bound for a saturated worker stall in its transfer queue — the herding
  pathology that blows up TTFT P99 under static greedy routing;
* template traffic is mildly skewed (realistic popularity), which is what
  lets cache-affinity herding concentrate load.

The cluster is a **unified worker-role pool**: one list of :class:`Worker`
objects, each carrying a role (``prefill``/``decode``), its spec, and its
role-specific state (busy flag vs. admission slots + transfer queue +
KVBM).  Static clusters fix the roles at construction; passing a
``planner_config`` closes the Game 1 loop — the Planner joins the event
loop as a third control-plane event (alongside ``poll``/``sync``) and may
flip one worker's role per adjust interval via the drain protocol: stop
admitting, drain running decodes, flush the worker's KVBM and invalidate
its KvIndexer claims, honor the grace period.  Repartitioning therefore
pays the paper's real switching costs (a flipped-in decode worker starts
cache-cold).

The cluster model generalizes along three scenario axes (see
``repro.serving.scenarios`` for the named registry): a prefill *pool*
(``num_prefill`` workers draining one shared queue), a possibly
heterogeneous decode pool (per-worker ``DecodeWorkerSpec`` — admission
cap, HBM blocks, ITL, KV-transfer latency — with capacity-normalized
router loads and capacity-weighted PoA counterfactuals), and three
workload modes (closed-loop ramps, open-loop Poisson/burst/diurnal
arrivals, JSONL trace replay).

Closed-loop clients maintain the workload's target concurrency. Calibrated
per model (340B / 70B; Section 7) so the paper's regime structure — PoA
plateau below the knee, first post-knee grid point at C=128, TTFT explosion
with flat ITL, throughput ceilings ≈18/47 rps — emerges from the same
mechanics the paper identifies (prefill-rate × request-residency ≈ C at the
knee). Calibration constants and deviations are logged in EXPERIMENTS.md.
"""
from __future__ import annotations

import heapq
import itertools
import math
import re
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.controller import violation_rates
from repro_torch.core.kvbm import KVBlockManager
from repro_torch.core.planner import PlannerConfig, ResponseModel
from repro_torch.core.poa import CompletedRequest
from repro_torch.core.radix import block_hashes
from repro_torch.core.router import KvRouterConfig
from repro_torch.core.saturation import DetectorConfig
from repro_torch.serving.control_plane import ControlPlane
from repro_torch.serving.fabric import (Fabric, FabricConfig, kv_hop_seconds,
                                  transfer_block_count)
from repro_torch.serving.workload import (WorkloadConfig, template_mix,
                                    template_tokens)

PREFILL_ROLE = "prefill"
DECODE_ROLE = "decode"

_TOPOLOGY_RE = re.compile(r"(\d+)\s*[Pp]\s*/\s*(\d+)\s*[Dd]")


@dataclass(frozen=True)
class DecodeWorkerSpec:
    """Per-decode-worker capacity profile (heterogeneous pools).

    A mixed-generation GPU pool is expressed as a tuple of these: newer
    cards get a larger ``decode_cap``/``g1_blocks`` and smaller
    ``itl_base``; remote nodes get a larger ``kv_transfer``.  The
    ``g2_blocks``/``g3_blocks`` tiers back the hierarchical KVBM (Def. 2):
    blocks demoted out of G1 HBM land in CPU DRAM then local SSD, from
    which they can be onboarded instead of recomputed (§8.4).
    """
    decode_cap: int = 60              # admission slots (transfer/batch)
    g1_blocks: int = 100_000          # HBM KV-block capacity
    g2_blocks: int = 400_000          # CPU-DRAM KV-block capacity
    g3_blocks: int = 1_600_000        # local-SSD KV-block capacity
    itl_base: float = 0.0090          # inter-token latency at low load (s)
    itl_slope: float = 0.000005       # load dependence (bandwidth-bound)
    kv_transfer: float = 0.012        # prefill→decode KV transfer latency (s)


@dataclass(frozen=True)
class ClusterConfig:
    """Calibrated per model/topology (paper Section 7.3/8).

    Homogeneous clusters use the scalar per-worker fields below; a
    heterogeneous decode pool is declared by ``decode_workers`` (a tuple of
    :class:`DecodeWorkerSpec`), which overrides the scalars and pins
    ``num_decode`` to its length.  ``num_prefill > 1`` models a prefill
    pool draining one shared queue.
    """
    name: str = "llama-3.1-70b"
    num_prefill: int = 1
    num_decode: int = 2
    prefill_rate: float = 47.0        # cache-warm requests/s ceiling per worker
    prefill_base: float = 0.015       # pipelined prefill latency component (s)
    miss_penalty: float = 0.65        # extra prefill work on a full cache miss
    itl_base: float = 0.0090          # inter-token latency at low load (s)
    itl_slope: float = 0.000005       # mild load dependence (bandwidth-bound)
    kv_transfer: float = 0.012        # cross-node KV transfer latency (s)
    decode_cap: int = 60              # admission slots per decode worker
    g1_blocks: int = 100_000          # per-decode-worker HBM block capacity
    g2_blocks: int = 400_000          # per-decode-worker CPU-DRAM blocks
    g3_blocks: int = 1_600_000        # per-decode-worker local-SSD blocks
    # Eq. 6 per-block onboarding latencies, α_G1 < α_G2 < α_G3 < α_G4 < γ
    # (a G1 hit is free; γ ≈ miss_penalty/prefill_rate per input block —
    # ~1.7 ms for the 70B defaults — bounds the alphas from above so
    # onboarding is always preferable to redundant recompute).
    alpha_g2: float = 0.0003          # G2→G1 onboarding per block (s)
    alpha_g3: float = 0.0012          # G3→G1 onboarding per block (s)
    alpha_g4: float = 0.0016          # G4→G1 onboarding per block (s)
    service_sigma: float = 0.5        # lognormal service jitter (batching)
    cache_ttl: float = 3.0            # radix-claim freshness (LRU churn model)
    metrics_interval: float = 1.0     # event-plane load-metric staleness (s)
    decode_workers: Tuple[DecodeWorkerSpec, ...] = ()

    def __post_init__(self):
        if self.decode_workers and self.num_decode != len(self.decode_workers):
            object.__setattr__(self, "num_decode", len(self.decode_workers))

    def default_spec(self) -> DecodeWorkerSpec:
        """The homogeneous per-worker spec built from the scalar fields —
        also what a prefill-origin worker carries into the decode pool."""
        return DecodeWorkerSpec(
            decode_cap=self.decode_cap, g1_blocks=self.g1_blocks,
            g2_blocks=self.g2_blocks, g3_blocks=self.g3_blocks,
            itl_base=self.itl_base, itl_slope=self.itl_slope,
            kv_transfer=self.kv_transfer)

    @property
    def worker_specs(self) -> Tuple[DecodeWorkerSpec, ...]:
        """Resolved per-worker specs (homogeneous scalars expanded)."""
        if self.decode_workers:
            return self.decode_workers
        return tuple(self.default_spec() for _ in range(self.num_decode))

    @classmethod
    def parse_topology(cls, topology: str) -> Tuple[int, int]:
        """Parse ``"<n>P/<m>D"`` into (num_prefill, num_decode), rejecting
        malformed strings (``"1P5D"``, ``"1p/"``, ``"2D/1P"``, …) with a
        clear error instead of silently mis-parsing them."""
        m = _TOPOLOGY_RE.fullmatch(topology.strip())
        if m is None:
            raise ValueError(
                f"malformed topology {topology!r}: expected \"<n>P/<m>D\" "
                f"(prefill workers, a slash, decode workers — e.g. \"1P/2D\")")
        npf, nd = int(m.group(1)), int(m.group(2))
        if npf < 1 or nd < 1:
            raise ValueError(
                f"topology {topology!r} needs at least one prefill and one "
                f"decode worker")
        return npf, nd

    @classmethod
    def for_model(cls, name: str, topology: str = "1P/2D") -> "ClusterConfig":
        npf, nd = cls.parse_topology(topology)
        if "340b" in name.lower() or "nemotron" in name.lower():
            return cls(name="nemotron-4-340b", num_prefill=npf, num_decode=nd,
                       prefill_rate=19.0, prefill_base=0.030,
                       itl_base=0.0214, kv_transfer=0.030,
                       decode_cap=58 if nd <= 2 else 30)
        return cls(name="llama-3.1-70b", num_prefill=npf, num_decode=nd,
                   prefill_rate=47.0 if nd <= 2 else 49.0,
                   prefill_base=0.015, itl_base=0.0090,
                   kv_transfer=0.012,
                   decode_cap=56 if nd <= 2 else 30)


@dataclass
class SimRequest:
    rid: int
    template: int
    tokens: List[int]
    output_tokens: int
    submit_t: float = 0.0
    prefill_start: float = 0.0
    prefill_end: float = 0.0
    decode_start: float = 0.0
    finish_t: float = 0.0
    decode_worker: int = -1
    overlap: float = 0.0
    overlaps_all: Tuple[float, ...] = ()
    loads_at_schedule: Tuple[float, ...] = ()
    phase: int = 0
    # tier-coherent cache accounting (quoted at scheduling time)
    hashes: Tuple[int, ...] = ()          # chained KV block hashes
    onboard_frac: float = 0.0             # blocks onboarded from G2/G3/G4
    onboard_latency: float = 0.0          # Eq. 6 onboarding TTFT add (s)
    # fabric accounting (fourth game; all zero/None when fabric is off)
    prefill_worker: int = -1              # wid whose NIC sources the transfer
    txm: Optional[object] = None          # live Transmission, if any
    transfer_wait: float = 0.0            # fabric service incl. link queueing
    transfer_floor: float = 0.0           # uncongested (OPT) transfer time

    @property
    def ttft(self) -> float:
        return self.prefill_end - self.submit_t

    @property
    def itl(self) -> float:
        return (self.finish_t - self.decode_start) / max(self.output_tokens, 1)


@dataclass
class Worker:
    """One GPU slot in the unified pool; ``role`` decides which state is
    live.

    Prefill-role workers drain the shared prefill queue (``busy``);
    decode-role workers own admission slots (``running`` vs
    ``spec.decode_cap``), a ``transfer_queue`` of stalled KV transfers, and
    a hierarchical ``kvbm``.  The Planner flips roles at runtime through
    the drain protocol: ``draining`` decode workers stop admitting and
    finish their running decodes before the flip completes; a busy prefill
    worker flagged ``pending_role`` flips at its next idle moment."""
    wid: int
    role: str
    spec: DecodeWorkerSpec
    # prefill-role state
    busy: bool = False
    # decode-role state
    running: int = 0
    peak_running: int = 0
    transfer_queue: Deque[SimRequest] = field(default_factory=deque)
    kvbm: Optional[KVBlockManager] = None
    # drain protocol
    draining: bool = False
    pending_role: Optional[str] = None


class Simulator:
    """Event-driven cluster; see module docstring."""

    def __init__(self, cluster: ClusterConfig, workload: WorkloadConfig,
                 router_config: Optional[KvRouterConfig] = None,
                 adaptive: bool = False,
                 detector_config: Optional[DetectorConfig] = None,
                 routing_policy: str = "kv",       # kv|round_robin|random|p2c
                 seed: int = 0,
                 regime_params: Optional[dict] = None,
                 planner_config: Optional[PlannerConfig] = None,
                 lean_completed: bool = False,
                 replicas: Optional[int] = None,
                 staleness: float = 0.0,
                 fabric: Optional[FabricConfig] = None,
                 network_aware: bool = False,
                 sanitize: Optional[bool] = None):
        self.cluster = cluster
        self.workload = workload
        # Control-plane scale-out: ``replicas=None`` keeps the legacy
        # single-router ControlPlane; an int builds a
        # ReplicatedControlPlane whose replica views refresh every
        # ``staleness`` sync events (staleness 0 = fresh views, pinned
        # bit-exact with the single-router path for any replica count).
        self.replicas = replicas
        self.staleness = staleness
        self._replica_sync_every = (max(int(round(staleness)), 1)
                                    if replicas is not None and staleness > 0
                                    else 0)
        self._sync_i = 0
        # Large-pool scenarios keep 100k+ completed requests around; the
        # per-request O(workers) overlap/load vectors are only consumed by
        # the PoA tracker (which holds its own windowed reference), so lean
        # mode drops them from a request once it is fully accounted.
        self.lean_completed = lean_completed
        # (template, input_tokens) → (tokens, chained block hashes): every
        # request of a template shares the same prompt, so tokenization and
        # hashing happen once per template instead of once per request.
        self._template_cache: dict = {}
        self.now = 0.0
        self._events: List[Tuple[float, int, str, object]] = []
        self._eid = itertools.count()
        self.rng = np.random.default_rng(seed)
        # dedicated stream for open-loop arrival sampling so closed-loop
        # runs stay byte-identical to the pre-scenario simulator
        self.arrival_rng = np.random.default_rng([seed, 0xA221])
        # Template popularity: shared with the engine backend (see
        # repro.serving.workload.template_mix) so both backends sample
        # identical template streams from identical seeds.
        self.template_probs = template_mix(workload.num_templates)

        # ---- unified worker-role pool: decode wids first (0..nd-1, the
        # legacy router universe), then the prefill pool (nd..nd+np-1).
        nd, npre = cluster.num_decode, cluster.num_prefill
        decode_specs = cluster.worker_specs
        prefill_spec = cluster.default_spec()
        self.workers: List[Worker] = (
            [Worker(w, DECODE_ROLE, decode_specs[w]) for w in range(nd)]
            + [Worker(nd + i, PREFILL_ROLE, prefill_spec)
               for i in range(npre)])
        self.decode_ids: List[int] = list(range(nd))
        self.prefill_ids: List[int] = list(range(nd, nd + npre))

        # ---- shared control plane (router + indexer + detector + adaptive
        # params + Planner + PoA + metrics).  Game 1: when a Planner is
        # configured the PoA universe widens to the whole pool (prefill-role
        # slots carry zero capacity, contributing no counterfactual
        # columns); without one the legacy decode-only universe keeps every
        # pre-existing scenario bit-exact.
        if planner_config is not None:
            self._poa_universe = list(range(nd + npre))
        else:
            self._poa_universe = list(range(nd))
        # Fourth game: an explicit fabric replaces the flat KV-hop charge —
        # transfers serialize on shared NIC/rack/spine links and (opt-in)
        # routing quotes effective transfer times from link queue depths.
        self.fabric = (Fabric(fabric, num_decode=nd, num_prefill=npre)
                       if fabric is not None else None)
        plane_kw = dict(
            router_config=router_config,
            routing_policy=routing_policy,
            seed=seed,
            adaptive=adaptive,
            detector_config=(detector_config
                             or DetectorConfig.for_model(cluster.name)),
            regime_params=regime_params,
            cache_ttl=cluster.cache_ttl,
            capacities={wid: float(self.workers[wid].spec.decode_cap)
                        for wid in self.decode_ids},
            poa_num_workers=len(self._poa_universe),
            poa_window_s=30.0,
            planner_config=planner_config,
            num_prefill=npre,
            fabric=self.fabric,
            network_aware=network_aware,
            sanitize=False)   # the simulator attaches its own, richer one
        if replicas is None:
            self.control = ControlPlane(nd, **plane_kw)
        else:
            from repro_torch.serving.control_plane import ReplicatedControlPlane
            self.control = ReplicatedControlPlane(
                nd, replicas=replicas,
                staleness_s=staleness * cluster.metrics_interval,
                **plane_kw)
        cp = self.control
        self.router = cp.router
        self.policy = cp.policy
        self.adaptive = cp.adaptive
        self.detector = cp.detector
        self.dual = cp.dual
        self.regime_params = cp.regime_params
        self.metrics = cp.metrics
        self.planner = cp.planner
        self.planner_config = cp.planner_config
        self.poa = cp.poa
        if self.planner is not None:
            # service-rate telemetry shares the Planner's measurement
            # window (histograms pin window_s at creation, so create them
            # here; without a Planner they default to the 30 s telemetry
            # window on first observation)
            win = self.planner_config.measure_window
            self.metrics.histogram("prefill_service", window_s=win)
            self.metrics.histogram("decode_residency", window_s=win)
        self.role_flips: List[Tuple[float, int, str]] = []
        self._arrivals: Deque[float] = deque()

        self.poa.capacities = self._poa_capacities()

        # Tier-coherent hierarchical cache: whenever KVBM demotes (or
        # frees) a block out of G1 HBM, the router's overlap claim for it
        # is invalidated, so cache-affinity routing only ever credits
        # G1-resident prefixes (the NetKV coherence channel).
        for wid in self.decode_ids:
            self.workers[wid].kvbm = self._new_kvbm(self.workers[wid])

        # shared prefill queue (deque: overload drains pop from the head
        # tens of thousands of times; list.pop(0) is O(n) per pop)
        self.prefill_queue: Deque[SimRequest] = deque()

        self.in_flight = 0
        self.completed: List[SimRequest] = []
        self._rid = itertools.count()
        self.poll_log: List[dict] = []

        # Opt-in runtime coherence sanitizer (repro.analysis.sanitize):
        # wraps the event handlers as instance attributes, so the default
        # (off) path carries no per-event branch at all.
        self.sanitizer = None
        if sanitize is not False:
            from repro_torch.analysis.sanitize import (attach_sim_sanitizer,
                                                 sanitize_enabled)
            if sanitize_enabled(sanitize):
                attach_sim_sanitizer(self)

    # ------------------------------------------------- pool projections -----
    #
    # Legacy views of the worker pool, ordered by the current decode/prefill
    # membership — what tests, benchmarks and examples indexed before the
    # unified pool existed.

    @property
    def specs(self) -> Tuple[DecodeWorkerSpec, ...]:
        return tuple(self.workers[w].spec for w in self.decode_ids)

    @property
    def kvbm(self) -> List[KVBlockManager]:
        return [self.workers[w].kvbm for w in self.decode_ids]

    @property
    def prefill_busy(self) -> List[bool]:
        return [self.workers[w].busy for w in self.prefill_ids]

    @property
    def decode_running(self) -> List[int]:
        return [self.workers[w].running for w in self.decode_ids]

    @property
    def peak_decode_running(self) -> List[int]:
        return [self.workers[w].peak_running for w in self.decode_ids]

    @property
    def transfer_queue(self) -> List[Deque[SimRequest]]:
        return [self.workers[w].transfer_queue for w in self.decode_ids]

    def _new_kvbm(self, worker: Worker) -> KVBlockManager:
        spec = worker.spec
        return KVBlockManager(
            {"G1": spec.g1_blocks, "G2": spec.g2_blocks,
             "G3": spec.g3_blocks},
            worker.wid,
            on_g1_evict=lambda h, _w=worker.wid:
                self.router.indexer.remove_worker_block(_w, h))

    def _poa_capacities(self) -> Tuple[float, ...]:
        if self.planner is None:
            return tuple(float(self.workers[w].spec.decode_cap)
                         for w in self.decode_ids)
        return tuple(float(w.spec.decode_cap) if w.role == DECODE_ROLE
                     else 0.0 for w in self.workers)

    # ---------------------------------------------------------- events ------

    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._events, (t, next(self._eid), kind, payload))

    def _committed_load(self, wid: int) -> float:
        w = self.workers[wid]
        return w.running + len(w.transfer_queue)

    def _live_decode_ids(self) -> List[int]:
        return [wid for wid in self.decode_ids
                if not self.workers[wid].draining]

    # ---------------------------------------------------------- client ------

    def _maybe_submit(self):
        """Closed-loop client: top the in-flight count up to the target
        (no-op for open-loop/trace workloads, whose target is 0)."""
        target = self.workload.concurrency_at(self.now)
        while self.in_flight < target:
            template = int(self.rng.choice(
                len(self.template_probs), p=self.template_probs))
            self._submit(template, self.workload.input_tokens,
                         self.workload.output_tokens)

    def _on_arrival(self, entry):
        """Open-loop/trace arrival (a TraceEntry): submit unconditionally —
        arrivals do not wait for completions."""
        template = entry.template
        if template < 0:  # open-loop: sample from the popularity skew
            template = int(self.rng.choice(
                len(self.template_probs), p=self.template_probs))
        self._submit(template, entry.input_tokens, entry.output_tokens)

    def _submit(self, template: int, input_tokens: int, output_tokens: int):
        cached = self._template_cache.get((template, input_tokens))
        if cached is None:
            toks = template_tokens(template, input_tokens)
            cached = (toks, tuple(block_hashes(toks)))
            self._template_cache[(template, input_tokens)] = cached
        req = SimRequest(rid=next(self._rid), template=template,
                         tokens=cached[0],
                         output_tokens=output_tokens,
                         submit_t=self.now,
                         hashes=cached[1],
                         phase=self.workload.phase_of(self.now))
        self.in_flight += 1
        if self.planner is not None:   # λ telemetry: only the Planner reads
            self._arrivals.append(self.now)
        self._route(req)
        self.prefill_queue.append(req)
        self._dispatch_prefill()

    # ---------------------------------------------------------- routing -----

    def _dense(self, ids: Sequence[int], vals: Sequence[float]
               ) -> Tuple[float, ...]:
        """Spread per-live-worker values over the fixed PoA universe
        (identity on the static path, where the live set IS the universe)."""
        if list(ids) == self._poa_universe:
            return tuple(vals)
        vec = [0.0] * len(self._poa_universe)
        for wid, v in zip(ids, vals):
            vec[wid] = v
        return tuple(vec)

    def _route(self, req: SimRequest):
        """Decode-worker selection at arrival (Game 3 mechanism).  The
        request's chained block hashes are memoized on the request (once
        per template, in fact) and threaded through every router/indexer
        call — the pre-memo hot path hashed the same prompt up to four
        times per routing decision."""
        if not req.hashes:   # trace entries below one block still memoize
            req.hashes = tuple(block_hashes(req.tokens))
        live = (self._live_decode_ids()
                if self.policy is not self.router else None)
        worker, overlap, overlaps, ids = self.control.select_worker(
            req.tokens, hashes=req.hashes, now=self.now, live_ids=live,
            rid=req.rid)
        req.decode_worker = worker
        req.overlap = overlap
        req.overlaps_all = self._dense(ids, overlaps)
        if not self.lean_completed:
            # routing-time load telemetry, carried into CompletedRequest
            # for offline analysis; skipped in lean mode (it is O(workers)
            # per request and nothing on the PoA path consumes it)
            workers = self.workers
            req.loads_at_schedule = tuple(
                (w.running + len(w.transfer_queue))
                if w.role == DECODE_ROLE else 0.0
                for w in (workers[wid] for wid in self._poa_universe))
        # the chosen worker's fresh credited prefix, recovered from its
        # overlap score (overlap = fresh / len(hashes) exactly) — the
        # separate matched_blocks() walk was redundant
        fresh = int(round(overlap * len(req.hashes)))
        req.onboard_frac, req.onboard_latency = self._tier_split(
            worker, req.hashes, fresh)
        self.router.on_schedule(worker, req.tokens, decode_blocks=0.0,
                                now=self.now, hashes=req.hashes)

    def _tier_split(self, w: int, hashes: Tuple[int, ...],
                    fresh_blocks: int) -> Tuple[float, float]:
        """Split a request's prefix blocks into G1 hits, onboardable
        lower-tier residents, and true misses (the §8.4 redundant-recompute
        vs. onboarding tradeoff).

        The first ``fresh_blocks`` blocks are the router-credited fresh G1
        prefix (coherent with HBM residency by construction).  Beyond it,
        blocks resident in G2/G3/G4 are onboarded at the per-tier Eq. 6
        latency instead of recomputed.  A block whose indexer claim went
        TTL-stale models vLLM-style HBM recycling: it is recomputed (a
        miss) even if the coarse KVBM still shows it G1-resident — which
        keeps large-G1 runs on the identity path — but recomputation
        restores its KV, so the walk continues through it to deeper
        lower-tier residents.  Lower-tier copies churn on the same
        ``cache_ttl`` clock (G2/G3 are shared caches, not archives): a
        demoted block is onboardable only while still fresh — exactly the
        window in which its G1 copy would have been a free hit — so tier
        pressure can convert free hits into paid onboards but never
        misses into hits.  The chain breaks at the first non-resident
        block: prefill recomputes the entire suffix from a true hole."""
        kv = self.workers[w].kvbm
        alpha = {"G2": self.cluster.alpha_g2, "G3": self.cluster.alpha_g3,
                 "G4": self.cluster.alpha_g4}
        onboard, latency = 0, 0.0
        for h in hashes[fresh_blocks:]:
            blk = kv.blocks.get(h)
            if blk is None:
                break
            if blk.tier != "G1" and \
                    self.now - blk.last_touch <= self.cluster.cache_ttl:
                onboard += 1
                latency += alpha[blk.tier]
        return onboard / max(len(hashes), 1), latency

    # --------------------------------------------------------- prefill ------

    def _dispatch_prefill(self):
        for wid in self.prefill_ids:
            w = self.workers[wid]
            if not w.busy and self.prefill_queue:
                req = self.prefill_queue.popleft()
                w.busy = True
                req.prefill_start = self.now
                # cache-warm routing skips recomputation; onboardable
                # G2/G3 blocks are fetched, not recomputed (they pay Eq. 6
                # latency at admission instead); only true misses cost
                # extra prefill work (throughput channel of §8.4).
                miss = max(1.0 - req.overlap - req.onboard_frac, 0.0)
                work = 1.0 + self.cluster.miss_penalty * miss
                sg = self.cluster.service_sigma
                service = (work / self.cluster.prefill_rate) \
                    * float(self.rng.lognormal(-0.5 * sg * sg, sg))
                self.metrics.histogram("prefill_service", window_s=30.0
                                       ).observe(service, self.now)
                self._push(self.now + service, "prefill_busy_done",
                           (wid, req))

    def _on_prefill_busy_done(self, wid: int, req: SimRequest):
        w = self.workers[wid]
        w.busy = False
        req.prefill_worker = wid     # this NIC sources the KV transfer
        if w.pending_role == DECODE_ROLE:
            # deferred Planner flip: the worker was mid-prefill when the
            # move was decided; it joins the decode pool now that it's idle
            self._finish_flip_to_decode(w)
        self._dispatch_prefill()
        self._push(self.now + self.cluster.prefill_base, "prefill_compute_done",
                   req)

    def _on_prefill_compute_done(self, req: SimRequest):
        """Prefill finished: KV transfer to the decode worker, subject to its
        admission cap (stalls here are the herding pathology)."""
        w = self.workers[req.decode_worker]
        if w.role != DECODE_ROLE or w.draining:
            # The target flipped (or is draining) while this request was in
            # the prefill pipeline: re-route to a live decode worker.
            # Prefill work already ran discounted by the *old* target's
            # overlap — that KV is still resident on the draining worker
            # (it flushes only after its last decode), so nothing is
            # recomputed; the switching cost the request pays is the
            # re-quoted transfer, kv_transfer·(1−overlap) against the new,
            # usually colder target.
            self._route(req)
        self._deliver(req)

    def _deliver(self, req: SimRequest):
        if self.fabric is not None:
            # the KV starts moving the moment prefill hands it off —
            # admission slots gate decode, not the wire — so the
            # transmission enqueues here, before the queue-or-admit split
            n = transfer_block_count(len(req.hashes), req.overlap)
            src = (req.prefill_worker if req.prefill_worker >= 0
                   else self.fabric.route_src(self.now))
            txm = self.fabric.enqueue(req.rid, src, req.decode_worker, n,
                                      self.now)
            req.txm = txm
            if txm is not None:
                req.transfer_wait = txm.finish_t - txm.enqueue_t
                req.transfer_floor = self.fabric.floor_seconds(src, n)
                self._push(txm.finish_t, "transfer_done", txm)
            else:
                req.transfer_wait = 0.0
                req.transfer_floor = 0.0
        w = self.workers[req.decode_worker]
        if w.running >= w.spec.decode_cap:
            w.transfer_queue.append(req)
            return
        self._admit_decode(req)

    def _admit_decode(self, req: SimRequest):
        w = self.workers[req.decode_worker]
        if w.role != DECODE_ROLE or w.draining:
            raise RuntimeError(
                f"drain-protocol violation: request {req.rid} admitted to "
                f"{'draining' if w.draining else w.role} worker {w.wid}")
        spec = w.spec
        # onboarding G2/G3 blocks into HBM delays first token by the
        # per-tier Eq. 6 latency (quoted at scheduling) — cheaper than the
        # full-recompute path a true miss pays in prefill work.
        if self.fabric is not None:
            # fabric charge: remaining wire time of the live transmission
            # (zero if it already landed while the request sat in the
            # admission queue, or if every block was resident)
            wire = (max(req.txm.finish_t - self.now, 0.0)
                    if req.txm is not None else 0.0)
            transfer = wire + req.onboard_latency
        else:
            transfer = kv_hop_seconds(spec.kv_transfer, 1.0 - req.overlap) \
                + req.onboard_latency
        req.prefill_end = self.now + transfer
        req.decode_start = req.prefill_end
        self.router.indexer.insert(w.wid, req.tokens, self.now,
                                   hashes=req.hashes)
        # allocate+access+pin+onboard per block, batched (admission pins
        # active decode state in G1; see KVBlockManager.admit_blocks)
        w.kvbm.admit_blocks(req.hashes, self.now)
        w.running += 1
        w.peak_running = max(w.peak_running, w.running)
        itl = spec.itl_base + spec.itl_slope * w.running
        dur = req.output_tokens * itl
        self._push(req.decode_start + dur, "decode_done", req)

    # ---------------------------------------------------------- decode ------

    def _on_decode_done(self, req: SimRequest):
        req.finish_t = self.now
        w = self.workers[req.decode_worker]
        w.running -= 1
        # Release the decode pins: the blocks stay resident (that is the
        # prefix-cache value) but become demotion-eligible again.
        for h in req.hashes:
            w.kvbm.unpin(h)
        self.in_flight -= 1
        self.completed.append(req)
        self.metrics.histogram("ttft", window_s=30.0).observe(req.ttft, self.now)
        self.metrics.histogram("itl", window_s=30.0).observe(req.itl, self.now)
        self.metrics.histogram("decode_residency", window_s=30.0).observe(
            req.finish_t - req.decode_start, self.now)
        self.poa.record(CompletedRequest(
            request_id=str(req.rid), worker=w.wid,
            latency=req.finish_t - req.submit_t,
            overlap=req.overlaps_all, finish_time=self.now,
            loads=req.loads_at_schedule,
            transfer_wait=req.transfer_wait,
            transfer_floor=req.transfer_floor))
        if self.lean_completed:
            # the PoA window holds its own reference to the overlap/load
            # vectors; dropping the request's copy bounds memory at
            # O(window) instead of O(completed × workers)
            req.overlaps_all = ()
            req.loads_at_schedule = ()
        if w.transfer_queue:
            nxt = w.transfer_queue.popleft()
            self._admit_decode(nxt)
        elif w.draining and w.running == 0:
            # last running decode finished: complete the Planner's flip
            self._finish_flip_to_prefill(w)
        self._maybe_submit()

    def _on_transfer_done(self, txm):
        """Fabric transmission landed: release its per-link byte
        reservation (a no-op if the drain protocol already cancelled it)."""
        self.fabric.complete(txm)

    # ------------------------------------------------ Game 1 repartition ----

    def _start_drain_to_prefill(self, w: Worker):
        """Drain protocol, step 1 (decode → prefill): stop admitting — the
        router marks the worker unhealthy so no new request routes to it —
        and re-route its stalled transfers; running decodes finish on
        their own clock."""
        w.draining = True
        self.router.set_health(w.wid, False)
        stalled = list(w.transfer_queue)
        w.transfer_queue.clear()
        for req in stalled:
            if self.fabric is not None and req.txm is not None:
                # transfer refund: release the reserved link capacity
                # BEFORE re-quoting against the new worker (sanitizer N1
                # catches transmissions left pointed at a drained worker)
                self.fabric.cancel(req.txm, self.now)
                req.txm = None
            self._route(req)
            self._deliver(req)
        if w.running == 0:
            self._finish_flip_to_prefill(w)

    def _finish_flip_to_prefill(self, w: Worker):
        """Drain protocol, step 2: flush the KVBM (every freed G1 block
        fires ``on_g1_evict`` → ``remove_worker_block``) and clear any
        remaining KvIndexer claims, then join the prefill pool."""
        for h in list(w.kvbm.blocks):
            w.kvbm.free(h)
        self.router.indexer.clear_worker(w.wid)
        w.kvbm = None
        w.draining = False
        w.role = PREFILL_ROLE
        w.busy = False
        self.decode_ids.remove(w.wid)
        self.prefill_ids.append(w.wid)
        self.prefill_ids.sort()
        self.poa.capacities = self._poa_capacities()
        if self.fabric is not None:
            self.fabric.set_pool(self.prefill_ids, self.decode_ids)
        self.role_flips.append((self.now, w.wid, "to_prefill"))
        self._dispatch_prefill()     # new prefill capacity is live now

    def _start_flip_to_decode(self):
        """Prefill → decode: flip the lowest-wid idle prefill worker
        immediately, or flag the lowest-wid one to flip when its current
        prefill job finishes (prefill jobs are tens of ms)."""
        idle = [wid for wid in self.prefill_ids if not self.workers[wid].busy]
        if idle:
            self._finish_flip_to_decode(self.workers[idle[0]])
        else:
            self.workers[self.prefill_ids[0]].pending_role = DECODE_ROLE

    def _finish_flip_to_decode(self, w: Worker):
        w.pending_role = None
        w.role = DECODE_ROLE
        w.kvbm = self._new_kvbm(w)   # cache-cold: the real switching cost
        w.running = 0
        w.peak_running = 0           # a fresh stint, not the pre-flip one
        w.transfer_queue.clear()
        self.prefill_ids.remove(w.wid)
        self.decode_ids.append(w.wid)
        self.decode_ids.sort()
        self.router.add_worker(w.wid, float(w.spec.decode_cap))
        self.poa.capacities = self._poa_capacities()
        if self.fabric is not None:
            self.fabric.set_pool(self.prefill_ids, self.decode_ids)
        self.role_flips.append((self.now, w.wid, "to_decode"))

    def _response_model(self) -> Optional[ResponseModel]:
        """Profiled Game 1 response curves at the measured operating point
        (arrival rate, prefill service time, decode residency)."""
        cfg = self.planner_config
        win = cfg.measure_window
        while self._arrivals and self._arrivals[0] < self.now - win:
            self._arrivals.popleft()
        span = min(self.now, win)
        if span <= 0.0 or not self._arrivals:
            return None
        lam = len(self._arrivals) / span
        s_p = self.metrics.histogram("prefill_service").mean(self.now)
        if s_p <= 0.0:
            s_p = (1.0 + 0.5 * self.cluster.miss_penalty) \
                / self.cluster.prefill_rate
        dspecs = [self.workers[wid].spec for wid in self.decode_ids] \
            or [self.workers[0].spec]
        itl_base = sum(s.itl_base for s in dspecs) / len(dspecs)
        itl_slope = sum(s.itl_slope for s in dspecs) / len(dspecs)
        cap = sum(s.decode_cap for s in dspecs) / len(dspecs)
        kv_transfer = sum(s.kv_transfer for s in dspecs) / len(dspecs)
        t_dec = self.metrics.histogram("decode_residency").mean(self.now)
        if t_dec <= 0.0:
            t_dec = self.workload.output_tokens * itl_base
        slack = max(cfg.ttft_slo - self.cluster.prefill_base - kv_transfer,
                    1e-3)
        return ResponseModel(arrival_rate=lam, prefill_service=s_p,
                             decode_residency=t_dec, itl_base=itl_base,
                             itl_slope=itl_slope, decode_cap=cap,
                             ttft_slack=slack, itl_slo=cfg.itl_slo)

    def _on_plan(self):
        """Third control-plane event (Game 1): feed the Planner the Eq. 5
        best-response marginals of the profiled response curves at the
        polled operating point; execute at most one role flip per adjust
        interval through the drain protocol."""
        busy_flip = any(w.draining or w.pending_role for w in self.workers)
        if not busy_flip:
            model = self._response_model()
            if model is not None:
                gp, gd = len(self.prefill_ids), len(self.decode_ids)
                m_p, m_d = model.marginals(gp, gd)
                if max(m_p, m_d) >= self.planner_config.min_signal:
                    move = self.planner.step(self.now, ttft_violation=m_p,
                                             itl_violation=m_d)
                    if move == "to_prefill":
                        victim = min(self._live_decode_ids(),
                                     key=lambda wid:
                                     (self._committed_load(wid), wid))
                        self._start_drain_to_prefill(self.workers[victim])
                    elif move == "to_decode":
                        self._start_flip_to_decode()
        nxt = self.now + self.planner_config.adjust_interval
        if nxt <= self.workload.total_duration() or (
                self.workload.mode != "closed" and self.in_flight > 0):
            self._push(nxt, "plan")

    # ------------------------------------------------------- controller -----

    @property
    def switch_time(self) -> Optional[float]:
        """Dual-frontend switch time (recorded by the control plane)."""
        return self.control.switch_time

    def _on_poll(self):
        ttft_p99 = self.metrics.histogram("ttft", window_s=30.0).p99(self.now)
        # include queued-but-unserved head-of-line wait so the detector sees
        # saturation forming (the paper's streamed frontend signal)
        if self.prefill_queue:
            hol = self.now - self.prefill_queue[0].submit_t
            ttft_p99 = max(ttft_p99, hol)
        regime = self.detector.observe(ttft_p99, self.now)
        poa = self.poa.current_poa(self.now)
        entry = {
            "t": self.now, "ttft_p99": ttft_p99, "regime": int(regime),
            "poa": poa, "poa_n": self.poa.window_size(self.now),
            "queue": len(self.prefill_queue),
            "decode_load": [self._committed_load(w)
                            for w in self.decode_ids],
            "concurrency": self.workload.concurrency_at(self.now),
            # Game 2 observables: Prop. 5's ρ per worker, tier residency,
            # and the demotion/promotion churn counters.
            "rho": [kv.capacity_ratio() for kv in self.kvbm],
            "tiers": [kv.tier_distribution() for kv in self.kvbm],
            "demotions": [kv.demotions for kv in self.kvbm],
            "promotions": [kv.promotions for kv in self.kvbm],
            # Game 1 observables: per-slot roles ("P"/"D", draining="d")
            # over the unified pool, and the realized P/D split.
            "roles": "".join(
                ("d" if w.draining else "D") if w.role == DECODE_ROLE
                else "P" for w in self.workers),
            "split": [len(self.prefill_ids), len(self.decode_ids)],
        }
        if self.planner is not None:
            pc = self.planner_config
            v_t, v_i = violation_rates(self.metrics, pc.ttft_slo, pc.itl_slo,
                                       self.now)
            entry["ttft_viol"] = v_t
            entry["itl_viol"] = v_i
            model = self._response_model()
            if model is not None:
                entry["resource_game"] = self.poa.resource_game(
                    model, len(self.prefill_ids), len(self.workers))
        if self.fabric is not None:
            # fourth-game observables: per-link queue depth/utilization and
            # the windowed network PoA (realized transfer wait vs the
            # social optimum's uncongested link assignment)
            entry["links"] = self.fabric.link_stats(self.now)
            entry["network_game"] = self.poa.network_game(self.now)
        self.poll_log.append(entry)
        for kv in self.kvbm:
            kv.decay()
        nxt = self.now + self.detector.config.poll_interval
        if nxt <= self.workload.total_duration():
            self._push(nxt, "poll")
        elif self.workload.mode != "closed" and self.in_flight > 0:
            # Open-loop/trace arrivals do not wait for completions, so the
            # run drains far past the arrival horizon; keep sampling the
            # detector/PoA/ρ while work is in flight — the overload tail
            # is the regime these modes exist to study.  (Closed-loop
            # keeps the legacy horizon so its outputs stay bit-exact.)
            self._push(nxt, "poll")

    # ------------------------------------------------------------- run ------

    def _on_sync(self):
        """Event-plane metric propagation: the router's load view is a
        periodic snapshot (staleness is what makes greedy τ=0 routing herd
        under saturation — the pathology τ>0 randomization suppresses)."""
        for wid in self.decode_ids:
            # b_active counts blocks ON the worker; queued NIXL transfers are
            # invisible to the router (incomplete-information pathology).
            self.router.workers[wid].active_blocks = \
                self.workers[wid].running
        if self._replica_sync_every:
            # replica views refresh every Nth sync event — the
            # deterministic event-clock staleness cadence (N = ``staleness``
            # sync intervals; the authoritative load copy above stays on
            # every sync, exactly like the single-router path)
            if self._sync_i % self._replica_sync_every == 0:
                self.control.sync_views(self.now)
            self._sync_i += 1
        nxt = self.now + self.cluster.metrics_interval
        if nxt <= self.workload.total_duration() + 30.0 or (
                self.workload.mode != "closed" and self.in_flight > 0):
            self._push(nxt, "sync")

    def run(self) -> "SimResult":
        total = self.workload.total_duration()
        self._push(0.0, "poll")
        self._push(0.0, "sync")
        if self.planner is not None:
            self._push(self.planner_config.adjust_interval, "plan")
        if self.workload.mode == "closed":
            t = 0.0
            while t < total:  # client ticks follow the ramp
                self._push(t, "tick")
                t += 1.0
        else:  # open-loop/trace: arrivals are pre-materialized events
            for entry in self.workload.arrivals(self.arrival_rng):
                self._push(entry.t, "arrive", entry)
        # Closed-loop keeps the legacy fixed drain margin (in-flight work is
        # bounded by the concurrency target).  Open-loop/trace arrivals don't
        # wait for completions, so overload — the regime these modes exist to
        # study — can queue far more than 60 s of backlog; drain it fully so
        # overall() prices every arrival instead of a survivor subset.
        closed = self.workload.mode == "closed"
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if closed and t > total + 60.0:  # drain margin
                break
            self.now = t
            if kind == "tick":
                self._maybe_submit()
            elif kind == "arrive":
                self._on_arrival(payload)
            elif kind == "prefill_busy_done":
                self._on_prefill_busy_done(*payload)
            elif kind == "prefill_compute_done":
                self._on_prefill_compute_done(payload)
            elif kind == "decode_done":
                self._on_decode_done(payload)
            elif kind == "transfer_done":
                self._on_transfer_done(payload)
            elif kind == "poll":
                self._on_poll()
            elif kind == "sync":
                self._on_sync()
            elif kind == "plan":
                self._on_plan()
        return SimResult(self)


@dataclass
class PhaseStats:
    poa: float
    poa_std: float
    ttft_p99: float
    itl_p99: float
    rps: float
    n: int


class SimResult:
    def __init__(self, sim: Simulator):
        self.sim = sim
        self.completed = sim.completed
        self.poll_log = sim.poll_log
        self.switch_time = sim.switch_time
        self.role_flips = sim.role_flips

    def _phase_reqs(self, phase: int) -> List[SimRequest]:
        return [r for r in self.completed if r.phase == phase]

    def _aggregate(self, reqs: List[SimRequest],
                   polls: List[dict]) -> PhaseStats:
        """Phase-agnostic aggregation over an explicit (requests, polls)
        slice — stats never mutate shared request state."""
        # exclude warm-up polls whose Eq. 12 window has not filled yet (the
        # denominator is count-normalized); keep all polls when the load is
        # too low to ever fill it (the paper's dagger-marked artifact rows).
        full = [p for p in polls
                if p.get("poa_n", 0) >= 0.8 * self.sim.poa.window_count]
        polls_used = full if full else polls
        poas = [p["poa"] for p in polls_used if p["poa"] == p["poa"]]
        if not reqs:
            return PhaseStats(float("nan"), 0.0, 0.0, 0.0, 0.0, 0)
        ttfts = sorted(r.ttft for r in reqs)
        itls = sorted(r.itl for r in reqs)
        p99 = lambda xs: xs[min(len(xs) - 1, max(0, math.ceil(0.99 * len(xs)) - 1))]
        dur = (max(r.finish_t for r in reqs) - min(r.submit_t for r in reqs))
        return PhaseStats(
            poa=float(np.mean(poas)) if poas else float("nan"),
            poa_std=float(np.std(poas)) if poas else float("nan"),
            ttft_p99=p99(ttfts), itl_p99=p99(itls),
            rps=len(reqs) / max(dur, 1e-9), n=len(reqs))

    def phase_stats(self, phase: int) -> PhaseStats:
        return self._aggregate(
            self._phase_reqs(phase),
            [p for p in self.poll_log
             if self.sim.workload.phase_of(p["t"]) == phase])

    def overall(self) -> PhaseStats:
        """Whole-run stats over every completed request and every poll
        (previously implemented by temporarily rewriting each request's
        ``phase`` — which mutated shared state and silently dropped the
        polls of every phase but the first from multi-phase runs)."""
        return self._aggregate(self.completed, self.poll_log)
