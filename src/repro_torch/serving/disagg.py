"""End-to-end disaggregated cluster on torch: port of
``src/repro/serving/disagg.py``, the **engine backend** of the shared
:class:`~repro_torch.serving.control_plane.ControlPlane`.

One prefill engine + N decode engines, glued by the same control plane the
analytic simulator runs on: Smart Router (Eq. 1/2) with KvIndexer overlap,
adaptive controller (saturation detector + Table 2 regime params), PoA
tracker, and per-request metrics.  The cluster runs on ``cuda`` unless the
caller passes another ``device``; its engines run there.

What makes this backend *real* rather than modeled:

* the prefill engine holds a block-granular prefix cache keyed by the same
  chained ``block_hashes`` the router scores overlap with, so a cache-warm
  routing decision resumes prefill from the matched block boundary and
  skips actual compute (cold requests pay the full pass);
* the prefill→decode ``transfer()`` hop is charged per **non-resident**
  block on the chosen decode worker (``kv_transfer_per_block`` seconds per
  block, added to the recorded TTFT/latency): on CPU the hop is an
  in-process copy, and the per-block charge reintroduces the KV-movement
  cost NetKV shows dominates decode-instance selection;
* per-token inter-token latencies are observed into the metrics registry,
  so ``violation_rates``' ITL side and the Planner's v_ITL signal are
  non-degenerate on real engines.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.poa import CompletedRequest
from repro_torch.core.radix import block_hashes
from repro_torch.core.router import KvRouterConfig
from repro_torch.core.saturation import DetectorConfig
from repro_torch.models.model import Model
from repro_torch.serving.control_plane import (ControlPlane,
                                               ReplicatedControlPlane)
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.fabric import Fabric, FabricConfig, kv_hop_seconds


@dataclass
class ServeRequest:
    request_id: str
    tokens: List[int]
    max_new_tokens: int = 16
    extras: Optional[dict] = None
    submit_t: float = 0.0
    first_token_t: float = 0.0
    last_token_t: float = 0.0
    finish_t: float = 0.0
    output: List[int] = field(default_factory=list)
    worker: int = -1
    overlap: float = 0.0
    overlaps: Tuple[float, ...] = ()
    hashes: Tuple[int, ...] = ()
    transfer_blocks: int = 0          # non-resident blocks the hop moved
    transfer_charge: float = 0.0      # seconds charged for that movement
    # fourth game (0.0 without a fabric): fabric service incl. link
    # queueing, and the uncongested (OPT) transfer time
    transfer_wait: float = 0.0
    transfer_floor: float = 0.0

    @property
    def ttft(self) -> float:
        """Wall-clock time to first token (compute only)."""
        return self.first_token_t - self.submit_t

    @property
    def charged_ttft(self) -> float:
        """TTFT including the per-block KV-transfer charge — what the
        metrics registry and PoA tracker observe."""
        return self.ttft + self.transfer_charge


class DisaggregatedCluster:
    """Engine backend: real torch engines driven by the shared control
    plane.  ``control`` may be injected (scenario runners do, to share
    decision logging); otherwise one is built from the kwargs."""

    def __init__(self, model: Model, params, *, num_decode: int = 2,
                 slots_per_worker: int = 4, max_len: int = 256,
                 adaptive: bool = True,
                 router_config: Optional[KvRouterConfig] = None,
                 detector_config: Optional[DetectorConfig] = None,
                 routing_policy: str = "kv",
                 cache_ttl: Optional[float] = None,
                 seed: int = 0,
                 prefill_cache_entries: int = 16,
                 kv_transfer_per_block: float = 0.0015,
                 batch_prefill: bool = True,
                 max_prefill_batch: int = 8,
                 decode_impl: str = "pallas",
                 num_pages: Optional[int] = None,
                 replicas: Optional[int] = None,
                 staleness_ticks: int = 0,
                 fabric: Optional[FabricConfig] = None,
                 network_aware: bool = False,
                 control: Optional[ControlPlane] = None,
                 sanitize: Optional[bool] = None,
                 device=None):
        if sanitize:
            raise NotImplementedError(
                "the coherence sanitizer is not ported yet (ROADMAP.md, "
                "queue item 'port sanitizer')")
        self.device = resolve_device(device)
        self.model = model
        self.batch_prefill = batch_prefill
        # Fourth game: decode NICs 0..N-1 plus one prefill node at wid=N
        # (the engine runs a single prefill engine); transfers serialize on
        # the shared links instead of the flat per-block charge.  Only used
        # when ``control`` is built here — an injected plane brings its own.
        self.fabric = (Fabric(fabric, num_decode=num_decode, num_prefill=1)
                       if fabric is not None else None)
        self.prefill = PrefillEngine(model, params, max_len,
                                     cache_entries=prefill_cache_entries,
                                     max_batch=max_prefill_batch,
                                     device=self.device)
        # num_pages sizes each paged decoder's KV page pool (None = the
        # dense worst case, where the page gate never binds); dense impls
        # ignore it.
        self.decoders = [DecodeEngine(model, params, slots_per_worker,
                                      max_len, worker_id=i,
                                      decode_impl=decode_impl,
                                      num_pages=num_pages,
                                      device=self.device)
                         for i in range(num_decode)]
        # Replica-view sync cadence on the engine backend: the scheduler
        # tick IS the event clock, so views refresh every
        # ``staleness_ticks`` step() calls (0 = fresh pass-through views —
        # bit-exact with the single-router plane for any replica count).
        self.staleness_ticks = staleness_ticks if replicas is not None else 0
        self._ticks = 0
        if control is not None:
            self.control = control
        else:
            plane_kw = dict(
                router_config=router_config,
                routing_policy=routing_policy,
                seed=seed,
                adaptive=adaptive,
                detector_config=(detector_config
                                 or DetectorConfig(theta1=0.5, theta2=5.0)),
                cache_ttl=cache_ttl,
                poa_window_s=60.0, poa_window_count=64,
                log_decisions=True,
                fabric=self.fabric,
                network_aware=network_aware,
                sanitize=False)   # the cluster attaches its own, richer one
            if replicas is None:
                self.control = ControlPlane(num_decode, **plane_kw)
            else:
                plane_kw["capacities"] = {
                    i: float(slots_per_worker) for i in range(num_decode)}
                self.control = ReplicatedControlPlane(
                    num_decode, replicas=replicas,
                    staleness_s=float(staleness_ticks), **plane_kw)
        self.router = self.control.router
        self.poa = self.control.poa
        self.metrics = self.control.metrics
        self.kv_transfer_per_block = kv_transfer_per_block
        self.pending: List[ServeRequest] = []
        self.running: Dict[str, Tuple[ServeRequest, int, int]] = {}
        self.done: List[ServeRequest] = []
        # per-tick decode occupancy snapshot (active slots per worker),
        # recorded by step(): the batch-occupancy observable
        # bench_engine_throughput histograms.  pool_utilization mirrors it
        # for paged decoders (fraction of each worker's page pool mapped
        # to live slots); empty for dense layouts.
        self.occupancy: List[Tuple[int, ...]] = []
        self.pool_utilization: List[Tuple[float, ...]] = []
        self._t0 = time.monotonic()
        self.sanitizer = None

    # ----------------------------------------------------------- lifecycle --

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def submit(self, req: ServeRequest):
        req.submit_t = self._now()
        if not req.hashes:
            req.hashes = tuple(block_hashes(req.tokens))
        self.pending.append(req)

    def _try_schedule(self):
        still: List[ServeRequest] = []
        placed: List[Tuple[ServeRequest, int, int]] = []
        for req in self.pending:
            # ONE routing call: its overlap vector is the pre-insert view —
            # the recorded PoA counterfactual must not self-credit the
            # request's own about-to-be-inserted blocks (the old second
            # ``best_worker`` call after ``on_schedule`` did exactly that).
            # record=False: backpressure retries re-route every tick, and
            # the decision_log must hold one entry per *placement*, not
            # one per abandoned attempt.
            now = self._now()
            worker, overlap, overlaps, _ids = self.control.route(
                req.tokens, hashes=req.hashes, now=now,
                rid=req.request_id, record=False)
            dec = self.decoders[worker]
            slot = dec.free_slot()
            if slot is None or not dec.can_admit(len(req.tokens),
                                                 req.max_new_tokens):
                # backpressure: no slot row, or (paged) the request's
                # worst-case page count is not coverable — retry next tick
                still.append(req)
                continue
            self.control.log_decision(req.request_id, worker, overlap, now)
            # reserve before the next request routes, so one tick's
            # placements see consistent slot accounting (paged engines
            # also reserve the worst-case page count here); the
            # compute for ALL of this tick's placements runs as one
            # bucketed prompt pass below.
            dec.reserve(slot, req.request_id, prompt_len=len(req.tokens),
                        max_new=req.max_new_tokens)
            self.control.router.on_schedule(worker, req.tokens,
                                            now=self._now(),
                                            hashes=req.hashes)
            req.worker = worker
            req.overlap = overlap
            req.overlaps = tuple(overlaps)
            placed.append((req, worker, slot))
        self.pending = still
        if not placed:
            return
        if self.batch_prefill:
            outs = self.prefill.prefill_many(
                [(req.tokens, req.extras, req.hashes)
                 for req, _, _ in placed])
        else:
            outs = [self.prefill.prefill(req.tokens, req.extras,
                                         hashes=req.hashes) + (0,)
                    for req, _, _ in placed]
        for (req, worker, slot), (logits, caches, row) in zip(placed, outs):
            first = int(np.argmax(logits))
            moved = self.decoders[worker].admit(
                slot, req.request_id, caches, first,
                prompt_len=len(req.tokens), max_new=req.max_new_tokens,
                hashes=req.hashes, src_row=row)
            req.transfer_blocks = moved
            if self.fabric is not None:
                # enqueue the sized transmission on the shared links; the
                # charge is the quoted-and-committed fabric service time
                # (store-and-forward over NIC/rack/spine incl. queueing)
                now2 = self._now()
                src = self.fabric.route_src(now2)
                txm = self.fabric.enqueue(req.request_id, src, worker,
                                          moved, now2)
                if txm is not None:
                    req.transfer_charge = txm.finish_t - now2
                    req.transfer_wait = txm.finish_t - txm.enqueue_t
                    req.transfer_floor = self.fabric.floor_seconds(src,
                                                                   moved)
                else:
                    req.transfer_charge = 0.0
            else:
                req.transfer_charge = kv_hop_seconds(
                    self.kv_transfer_per_block, moved)
            req.first_token_t = self._now()
            req.last_token_t = req.first_token_t
            req.output = [first]
            self.running[req.request_id] = (req, worker, slot)

    def step(self) -> int:
        """One scheduler tick: admit pending, advance every decode engine.
        Returns number of completed requests this tick."""
        if self.fabric is not None:
            # lazy settlement: the engine has no event queue, so landed
            # transmissions release their link reservations at tick start
            self.fabric.complete_until(self._now())
        if self.staleness_ticks > 0:
            if self._ticks % self.staleness_ticks == 0:
                self.control.sync_views(self._now())
            self._ticks += 1
        self._try_schedule()
        self.occupancy.append(tuple(d.active_count for d in self.decoders))
        if any(d.paged for d in self.decoders):
            self.pool_utilization.append(
                tuple(d.pool_utilization() for d in self.decoders))
        completed = 0
        for dec in self.decoders:
            for rid, tok, done in dec.step():
                req, worker, _slot = self.running[rid]
                now = self._now()
                req.output.append(tok)
                # per-token ITL: every decode step contributes a sample, so
                # the ITL histogram (and the Planner's v_ITL) is live on
                # the engine path, not just TTFT
                self.metrics.histogram("itl", window_s=300.0).observe(
                    now - req.last_token_t, now)
                req.last_token_t = now
                if done:
                    # slot already released inside dec.step() (returned-slot
                    # contract: done=True means re-admittable this tick)
                    req.finish_t = now
                    del self.running[rid]
                    self.done.append(req)
                    self.control.router.on_complete(worker, req.tokens)
                    self.metrics.histogram("ttft", window_s=300.0).observe(
                        req.charged_ttft, now)
                    self.poa.record(CompletedRequest(
                        request_id=rid, worker=worker,
                        latency=(req.finish_t - req.submit_t
                                 + req.transfer_charge),
                        overlap=req.overlaps, finish_time=now,
                        transfer_wait=req.transfer_wait,
                        transfer_floor=req.transfer_floor))
                    completed += 1
        # controller telemetry poll (every tick at test scale)
        ttft_p99 = self.metrics.histogram("ttft", window_s=300.0).p99(self._now())
        self.control.observe(ttft_p99, self._now())
        return completed

    def run_until_done(self, max_ticks: int = 10_000) -> List[ServeRequest]:
        ticks = 0
        while (self.pending or self.running) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.done
