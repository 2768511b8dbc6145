"""Runtime coherence sanitizer — opt-in cross-structure invariant checks.

The serving hot path is fast because it trusts a handful of coherence
invariants instead of recomputing state: the router's cached dense load
vector, the indexer's claim counters, KVBM pin refcounts, the drain
protocol, the engine's slot lifecycle.  The sanitizer re-derives each of
those from first principles at event/tick boundaries and raises
:class:`SanitizeError` — with the recent event trace attached — the moment
the cheap view and the recomputed truth diverge.

Enablement (default OFF, zero-cost when off — attachment happens once at
construction, never per event):

* ``REPRO_SANITIZE=1`` in the environment, or
* ``sanitize=True`` on :class:`~repro.serving.simulator.Simulator`,
  :class:`~repro.serving.control_plane.ControlPlane`, or
  :class:`~repro.serving.disagg.DisaggregatedCluster`.

Every check is a pure read: no RNG draws, no event pushes, no lazy tree
sweeps (the radix audit walks read-only, unlike ``overlap_depths``), so a
sanitized run is bit-exact with an un-instrumented one
(``tests/test_sanitizer.py`` pins this over the whole scenario registry).

Invariants checked on the analytic backend (:class:`SimSanitizer`):

I1  indexer claims ⊆ G1-resident KVBM blocks, modulo requests routed but
    not yet admitted (and draining workers, whose inert claims flush at
    the role flip);
I2  pin refcounts ≥ 0, and every block's pin count equals the number of
    admitted in-flight requests whose hash chain contains it (pin/unpin
    balanced at completion; no pin leaks);
I3  pinned blocks are never demoted, freed, or over-unpinned;
I4  radix tree structure: parent links, ``_node_by_hash`` ≡ live nodes,
    empty-node pruning, claim counters, prefix closure;
I5  router's cached dense load vector ≡ a fresh recompute from the table;
I6  the drain protocol never routes to or admits onto a draining/
    non-decode worker, and draining workers hold no queued transfers;
I7  per-worker ``running`` equals the recomputed admitted-request count.

On the engine backend (:class:`EngineSanitizer`): I4/I5 plus the
``DecodeEngine`` slot lifecycle — reserve only into a free slot, admit
only into the slot reserved for that request (no stale-KV slot reuse),
slot table ≡ the cluster's running/placed view at every tick boundary —
and, for paged decoders, the page-pool invariants: free list ∪ live page
tables exactly partitions the pool (P1), no page owned by two live slots
(P2), released slots hold zero pages (P3).

Fabric (both backends, when a :class:`~repro.serving.fabric.Fabric` is
attached):

N1  per-link byte conservation: every link's ``bytes_inflight`` equals
    the recomputed sum over live transmissions whose path crosses it —
    enqueue/complete/cancel (the drain-protocol refund) must balance;
    and on the analytic backend no live transmission targets a draining
    or non-decode worker unless its request was already admitted there
    before the drain began;
N2  quote/charge parity: the network-aware router's pure quote replays
    exactly as the committed transmission's finish time — pricing and
    charging share one link-scheduling routine.

Replicated control plane (both backends, when ``replica_views`` exist):

R1  bounded staleness: no replica view's age ever exceeds its configured
    bound — event-clock seconds on the analytic backend, scheduler ticks
    since the last ``sync_views`` on the engine backend;
R2  snapshot integrity: each view's base snapshot (healthy set, load
    vector, regime, hash claims) is identical to the frozen copy recorded
    when ``sync_views`` ran — nothing but ``sync()`` may rewrite it (the
    runtime complement of lint rule RA011).
"""
from __future__ import annotations

import os
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

TRACE_LEN = 32


def sanitize_enabled(default: Optional[bool] = None) -> bool:
    """Resolve the sanitizer switch: an explicit ``sanitize=`` argument
    wins; otherwise the ``REPRO_SANITIZE`` environment variable."""
    if default is not None:
        return bool(default)
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


class SanitizeError(AssertionError):
    """A coherence invariant failed.  The message carries the invariant,
    the divergence, and the recent event trace for context."""

    def __init__(self, invariant: str, detail: str,
                 trace: Optional[Deque[str]] = None):
        self.invariant = invariant
        self.detail = detail
        lines = [f"sanitizer: {invariant}: {detail}"]
        if trace:
            lines.append("recent events (oldest first):")
            lines.extend(f"  {e}" for e in trace)
        super().__init__("\n".join(lines))


class _Trace:
    """Bounded ring buffer of recent event descriptions."""

    def __init__(self, maxlen: int = TRACE_LEN):
        self.events: Deque[str] = deque(maxlen=maxlen)

    def add(self, desc: str) -> None:
        self.events.append(desc)

    def fail(self, invariant: str, detail: str) -> None:
        raise SanitizeError(invariant, detail, self.events)


def _check_frozen_views(control, frozen, trace: _Trace, where: str) -> None:
    """R2: every replica view's base snapshot must equal the frozen copy
    recorded at the last ``sync_views`` — a mismatch means replica-side
    code rewrote snapshot state between syncs."""
    views = getattr(control, "replica_views", ())
    for v, want in zip(views, frozen):
        got = v.frozen_state()
        if got != want:
            labels = ("synced_at", "healthy ids", "loads", "regime",
                      "hash claims", "fabric links")
            diffs = [labels[i] if i < len(labels) else f"field {i}"
                     for i in range(max(len(got), len(want)))
                     if (got[i:i + 1] or None) != (want[i:i + 1] or None)]
            trace.fail(
                "R2 replica snapshot integrity",
                f"at {where}: replica {v.index} base snapshot diverged "
                f"from its sync-time frozen copy in: {', '.join(diffs)} — "
                f"only sync() may rewrite snapshot state")


def _check_fabric(fabric, trace: _Trace, where: str,
                  live_dsts: Optional[Set[int]] = None,
                  admitted_rids: Optional[Set] = None) -> None:
    """N1: recompute every link's ``bytes_inflight`` from the live
    transmission set and compare to the incrementally-maintained counter
    — an imbalance means an enqueue/complete/cancel edge (most likely the
    drain-protocol refund) leaked or double-released bytes.  With
    ``live_dsts`` (analytic backend), also check that no live
    transmission still targets a drained destination unless its request
    was admitted there before the drain began."""
    expect: Dict[str, int] = {}
    for txm in fabric.active.values():
        for name in txm.path:
            expect[name] = expect.get(name, 0) + txm.size
        if live_dsts is not None and txm.dst not in live_dsts:
            if admitted_rids is None or txm.rid not in admitted_rids:
                trace.fail(
                    "N1 fabric byte conservation (drain)",
                    f"at {where}: transmission tid={txm.tid} "
                    f"(rid={txm.rid}) still in flight toward drained "
                    f"worker {txm.dst} — the drain protocol must cancel "
                    f"before re-routing")
    for name in sorted(fabric.links):
        link = fabric.links[name]
        want = expect.get(name, 0)
        if link.bytes_inflight != want:
            trace.fail(
                "N1 fabric byte conservation",
                f"at {where}: link {name} accounts "
                f"bytes_inflight={link.bytes_inflight} but live "
                f"transmissions crossing it sum to {want}")


def _wrap_fabric_enqueue(fabric, trace: _Trace):
    """N2: wrap ``fabric.enqueue`` so every committed transfer is checked
    against the pure quote taken an instant before — pricing (what the
    network-aware router sees) and charging (what the request pays) must
    replay identically."""
    orig = fabric.enqueue

    def enqueue(rid, src, dst, n_blocks, now):
        quoted = fabric.quote(src, dst, n_blocks, now)
        txm = orig(rid, src, dst, n_blocks, now)
        if txm is not None:
            trace.add(f"t={now:.4f} xfer rid={rid} {src}->{dst} "
                      f"{n_blocks}blk finish={txm.finish_t:.4f}")
            charged = txm.finish_t - now
            if abs(charged - quoted) > 1e-9:
                trace.fail(
                    "N2 fabric quote/charge parity",
                    f"tid={txm.tid} (rid={rid}) {src}->{dst}: quoted "
                    f"{quoted:.9f}s but charged {charged:.9f}s — the "
                    f"router priced a different fabric than the one "
                    f"that carried the transfer")
        return txm

    fabric.enqueue = enqueue


# -------------------------------------------------------------- analytic ----


class SimSanitizer:
    """Coherence checks over a :class:`~repro.serving.simulator.Simulator`.

    Attached by wrapping the simulator's bound event handlers as instance
    attributes (the class stays untouched — an unsanitized simulator pays
    nothing).  Light per-event checks run inline; the full cross-structure
    sweep runs at the ``sync``/``poll`` boundaries, where the event plane
    itself re-derives state.
    """

    def __init__(self, sim):
        self.sim = sim
        self.trace = _Trace()
        # rid -> (worker, hash set): routed (claims inserted) but not yet
        # admitted (blocks not yet in the KVBM) — the I1 exemption window
        self.pending: Dict[int, Tuple[int, Set[int]]] = {}
        # rid -> (worker, hash chain): admitted, in-flight decodes — the
        # ground truth I2/I7 recompute from
        self.admitted: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # R2: frozen snapshot copies, recorded per sync_views (replicated
        # control plane only; ReplicatedControlPlane syncs once during
        # construction, before attachment, so seed the record here)
        self.view_frozen: List[tuple] = []
        self._instrument()
        if getattr(sim.control, "replica_views", None):
            self._sync_views = sim.control.sync_views
            sim.control.sync_views = self._wrap_sync_views
            self.view_frozen = [v.frozen_state()
                                for v in sim.control.replica_views]

    # ------------------------------------------------------------- wiring ---

    def _instrument(self) -> None:
        sim = self.sim
        self._route = sim._route
        self._admit = sim._admit_decode
        self._done = sim._on_decode_done
        self._sync = sim._on_sync
        self._poll = sim._on_poll
        self._new_kvbm = sim._new_kvbm
        sim._route = self._wrap_route
        sim._admit_decode = self._wrap_admit
        sim._on_decode_done = self._wrap_done
        sim._on_sync = self._wrap_sync
        sim._on_poll = self._wrap_poll
        sim._new_kvbm = self._wrap_new_kvbm
        for wid in sim.decode_ids:
            self._instrument_kvbm(sim.workers[wid].kvbm)
        if getattr(sim, "fabric", None) is not None:
            _wrap_fabric_enqueue(sim.fabric, self.trace)

    def _instrument_kvbm(self, kv) -> None:
        """Guard the eviction/refcount edges of one KVBM: demoting or
        freeing a pinned block, or unpinning past zero, fails immediately
        (the state it corrupts may be unreachable by the next sweep)."""
        if kv is None or getattr(kv, "_sanitized", False):
            return
        kv._sanitized = True
        orig_demote, orig_free, orig_unpin = kv._demote, kv.free, kv.unpin

        def demote(blk):
            if blk.pin_count > 0:
                self.trace.fail(
                    "I3 pinned-block eviction",
                    f"worker {kv.worker_id}: demoting block "
                    f"{blk.block_id:#x} out of {blk.tier} with "
                    f"pin_count={blk.pin_count}")
            return orig_demote(blk)

        def free(block_id):
            blk = kv.blocks.get(block_id)
            if blk is not None and blk.pin_count > 0:
                self.trace.fail(
                    "I3 pinned-block free",
                    f"worker {kv.worker_id}: freeing block {block_id:#x} "
                    f"with pin_count={blk.pin_count}")
            return orig_free(block_id)

        def unpin(block_id):
            blk = kv.blocks.get(block_id)
            if blk is not None and blk.pin_count == 0:
                self.trace.fail(
                    "I2 unbalanced unpin",
                    f"worker {kv.worker_id}: unpin of block {block_id:#x} "
                    f"already at pin_count=0")
            return orig_unpin(block_id)

        kv._demote = demote
        kv.free = free
        kv.unpin = unpin

    # ----------------------------------------------------------- wrappers ---

    def _wrap_new_kvbm(self, worker):
        kv = self._new_kvbm(worker)
        self._instrument_kvbm(kv)
        return kv

    def _wrap_route(self, req):
        self._route(req)
        sim = self.sim
        w = sim.workers[req.decode_worker]
        self.trace.add(f"t={sim.now:.4f} route rid={req.rid} -> "
                       f"worker {req.decode_worker} overlap={req.overlap:.3f}")
        if w.role != "decode" or w.draining:
            self.trace.fail(
                "I6 drain protocol (routing)",
                f"rid {req.rid} routed to "
                f"{'draining' if w.draining else w.role} worker {w.wid}")
        self.pending[req.rid] = (req.decode_worker, set(req.hashes))

    def _wrap_admit(self, req):
        sim = self.sim
        w = sim.workers[req.decode_worker]
        if w.role != "decode" or w.draining:
            # the simulator's own RuntimeError would also fire inside
            # _admit_decode; failing here attaches the event trace
            self.trace.fail(
                "I6 drain protocol (admission)",
                f"rid {req.rid} admitted to "
                f"{'draining' if w.draining else w.role} worker {w.wid}")
        self._admit(req)
        self.trace.add(f"t={sim.now:.4f} admit rid={req.rid} on "
                       f"worker {req.decode_worker}")
        self.pending.pop(req.rid, None)
        self.admitted[req.rid] = (req.decode_worker, tuple(req.hashes))

    def _wrap_done(self, req):
        self.trace.add(f"t={self.sim.now:.4f} decode_done rid={req.rid} on "
                       f"worker {req.decode_worker}")
        self._done(req)
        self.admitted.pop(req.rid, None)

    def _wrap_sync(self):
        self._sync()
        self.trace.add(f"t={self.sim.now:.4f} sync")
        self.check_all("sync")

    def _wrap_sync_views(self, now):
        self._sync_views(now)
        self.trace.add(f"t={now:.4f} sync_views")
        self.view_frozen = [v.frozen_state()
                            for v in self.sim.control.replica_views]

    def _wrap_poll(self):
        self._poll()
        self.trace.add(f"t={self.sim.now:.4f} poll")
        self.check_all("poll")

    # ------------------------------------------------------------- checks ---

    def check_all(self, where: str = "sweep") -> None:
        """The full cross-structure sweep (pure reads only)."""
        sim = self.sim
        fail = self.trace.fail

        # I5: router load-vector cache vs fresh recompute
        divergence = sim.router.cache_coherent()
        if divergence is not None:
            fail("I5 router load-cache coherence", f"at {where}: {divergence}")

        # I4: radix tree structural audit (read-only walk)
        for problem in sim.router.indexer.audit():
            fail("I4 radix tree consistency", f"at {where}: {problem}")

        # R1/R2: replicated control plane — view age within the staleness
        # bound, base snapshots bit-identical to their sync-time copies
        views = getattr(sim.control, "replica_views", ())
        for v in views:
            age = v.age(sim.now)
            if age > v.bound + 1e-9:
                fail("R1 replica staleness bound",
                     f"at {where}: replica {v.index} view age {age:.6f}s "
                     f"exceeds its configured bound {v.bound:.6f}s "
                     f"(synced_at={v.synced_at})")
        if views:
            _check_frozen_views(sim.control, self.view_frozen, self.trace,
                                where)

        # N1: fabric byte conservation + drain closure over live transfers
        if getattr(sim, "fabric", None) is not None:
            live = {wid for wid in sim.decode_ids
                    if not sim.workers[wid].draining}
            _check_fabric(sim.fabric, self.trace, where, live_dsts=live,
                          admitted_rids=set(self.admitted))

        # recompute the admitted view once: per-worker running counts and
        # per-(worker, hash) expected pin counts
        running: Dict[int, int] = {}
        expected_pins: Dict[int, Dict[int, int]] = {}
        for _rid, (wid, hashes) in self.admitted.items():
            running[wid] = running.get(wid, 0) + 1
            pins = expected_pins.setdefault(wid, {})
            for h in hashes:
                pins[h] = pins.get(h, 0) + 1
        pending_by_worker: Dict[int, Set[int]] = {}
        for _rid, (wid, hset) in self.pending.items():
            pending_by_worker.setdefault(wid, set()).update(hset)

        for wid in sim.decode_ids:
            w = sim.workers[wid]
            kv = w.kvbm

            # I6: draining workers admit nothing and queue nothing
            if w.draining and w.transfer_queue:
                fail("I6 drain protocol (queued transfers)",
                     f"at {where}: draining worker {wid} still holds "
                     f"{len(w.transfer_queue)} queued transfer(s)")

            # I7: admission-slot accounting
            if w.running != running.get(wid, 0):
                fail("I7 slot accounting",
                     f"at {where}: worker {wid} reports running={w.running} "
                     f"but {running.get(wid, 0)} admitted request(s) are "
                     f"in flight")

            if kv is None:
                continue

            # KVBM internal accounting (tier recounts, pin sign)
            for problem in kv.audit():
                fail("I2 KVBM accounting",
                     f"at {where}: worker {wid}: {problem}")

            # I2: pin refcounts ≡ admitted in-flight coverage
            pins = expected_pins.get(wid, {})
            for h, n in pins.items():
                blk = kv.blocks.get(h)
                if blk is None:
                    fail("I2 pin balance",
                         f"at {where}: worker {wid}: block {h:#x} backs "
                         f"{n} in-flight decode(s) but is gone from the "
                         f"KVBM")
                elif blk.pin_count != n:
                    fail("I2 pin balance",
                         f"at {where}: worker {wid}: block {h:#x} has "
                         f"pin_count={blk.pin_count}, expected {n} from "
                         f"in-flight decodes")
            for h, blk in kv.blocks.items():
                if blk.pin_count > 0 and h not in pins:
                    fail("I2 pin leak",
                         f"at {where}: worker {wid}: block {h:#x} has "
                         f"pin_count={blk.pin_count} but no in-flight "
                         f"decode covers it")

            # I1: claims ⊆ G1-resident ∪ pending-routed (draining workers'
            # claims are inert — router health is off — and flush at flip)
            if not w.draining:
                pend = pending_by_worker.get(wid, ())
                for h in sim.router.indexer.claimed_hashes(wid):
                    blk = kv.blocks.get(h)
                    if blk is not None and blk.tier == "G1":
                        continue
                    if h in pend:
                        continue
                    fail("I1 claim/residency closure",
                         f"at {where}: worker {wid} claims block {h:#x} "
                         f"which is "
                         + (f"resident in {blk.tier}, not G1" if blk
                            else "not in its KVBM")
                         + " and not pending admission")


def attach_sim_sanitizer(sim) -> SimSanitizer:
    """Instrument a Simulator in place; returns the sanitizer (exposed as
    ``sim.sanitizer``)."""
    san = SimSanitizer(sim)
    sim.sanitizer = san
    return san


# --------------------------------------------------------------- engines ----


class EngineSanitizer:
    """Coherence checks over a
    :class:`~repro.serving.disagg.DisaggregatedCluster` (engine backend).

    Per-call slot-lifecycle guards on every :class:`DecodeEngine` plus a
    control-plane sweep (I4/I5) and a slot-table ≡ running-view recompute
    at each tick boundary."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.trace = _Trace()
        # (worker, slot) -> request_id reserved but not yet admitted
        self.reserved: Dict[Tuple[int, int], str] = {}
        # R1 (engine clock = scheduler ticks) / R2 state
        self.view_frozen: List[tuple] = []
        self.ticks_since_sync = 0
        self._instrument()

    def _instrument(self) -> None:
        cl = self.cluster
        for dec in cl.decoders:
            self._instrument_decoder(dec)
        self._step = cl.step
        cl.step = self._wrap_step
        if getattr(cl, "fabric", None) is not None:
            _wrap_fabric_enqueue(cl.fabric, self.trace)
        if getattr(cl.control, "replica_views", None):
            self._sync_views = cl.control.sync_views
            cl.control.sync_views = self._wrap_sync_views
            self.view_frozen = [v.frozen_state()
                                for v in cl.control.replica_views]

    def _wrap_sync_views(self, now):
        self._sync_views(now)
        self.trace.add(f"t={now:.4f} sync_views")
        self.ticks_since_sync = 0
        self.view_frozen = [v.frozen_state()
                            for v in self.cluster.control.replica_views]

    def _instrument_decoder(self, dec) -> None:
        wid = dec.worker_id
        orig_reserve, orig_admit, orig_release = (
            dec.reserve, dec.admit, dec.release)

        def reserve(slot, request_id, prompt_len=None, max_new=0):
            s = dec.slots[slot]
            if s.active:
                self.trace.fail(
                    "E1 slot reuse (reserve)",
                    f"worker {wid}: reserving slot {slot} for "
                    f"{request_id!r} while it is held by {s.request_id!r}")
            self.trace.add(f"reserve w{wid}/s{slot} <- {request_id!r}")
            if prompt_len is None:
                out = orig_reserve(slot, request_id)
            else:
                out = orig_reserve(slot, request_id, prompt_len=prompt_len,
                                   max_new=max_new)
            self.reserved[(wid, slot)] = request_id
            return out

        def admit(slot, request_id, prefill_caches, first_token,
                  prompt_len, max_new, hashes=(), src_row=0):
            s = dec.slots[slot]
            holder = self.reserved.get((wid, slot))
            if s.active and s.request_id != request_id:
                self.trace.fail(
                    "E1 slot reuse (admit)",
                    f"worker {wid}: admitting {request_id!r} into slot "
                    f"{slot} held by {s.request_id!r} — stale KV would be "
                    f"served")
            if holder is not None and holder != request_id:
                self.trace.fail(
                    "E1 slot reuse (admit)",
                    f"worker {wid}: slot {slot} reserved for {holder!r} "
                    f"but admitted {request_id!r}")
            self.trace.add(f"admit w{wid}/s{slot} <- {request_id!r} "
                           f"(prompt_len={prompt_len})")
            out = orig_admit(slot, request_id, prefill_caches, first_token,
                             prompt_len, max_new, hashes=hashes,
                             src_row=src_row)
            self.reserved.pop((wid, slot), None)
            return out

        def release(slot):
            self.trace.add(f"release w{wid}/s{slot}")
            self.reserved.pop((wid, slot), None)
            return orig_release(slot)

        dec.reserve = reserve
        dec.admit = admit
        dec.release = release

    def _wrap_step(self):
        out = self._step()
        self.trace.add(f"tick t={self.cluster._now():.4f} "
                       f"completed={out}")
        self.check_all("tick")
        return out

    def check_all(self, where: str = "tick") -> None:
        cl = self.cluster
        fail = self.trace.fail

        divergence = cl.control.router.cache_coherent()
        if divergence is not None:
            fail("I5 router load-cache coherence", f"at {where}: {divergence}")
        for problem in cl.control.router.indexer.audit():
            fail("I4 radix tree consistency", f"at {where}: {problem}")

        # R1/R2: the engine's event clock is the scheduler tick — views
        # must refresh within ``staleness_ticks`` ticks, and base
        # snapshots must match their sync-time frozen copies
        if getattr(cl.control, "replica_views", None):
            self.ticks_since_sync += 1
            bound = max(cl.staleness_ticks, 1)
            if self.ticks_since_sync > bound:
                fail("R1 replica staleness bound",
                     f"at {where}: {self.ticks_since_sync} tick(s) since "
                     f"the last sync_views exceeds the configured cadence "
                     f"of {bound} tick(s)")
            _check_frozen_views(cl.control, self.view_frozen, self.trace,
                                where)

        # N1: fabric byte conservation (no drain protocol on this backend)
        if getattr(cl, "fabric", None) is not None:
            _check_fabric(cl.fabric, self.trace, where)

        # E2: slot table ≡ cluster running view.  Every running request
        # owns exactly its recorded slot; every active slot is owned by a
        # running request or a live reservation.
        owned: Dict[Tuple[int, int], str] = dict(self.reserved)
        for rid, (_req, worker, slot) in cl.running.items():
            s = cl.decoders[worker].slots[slot]
            if not s.active or s.request_id != rid:
                fail("E2 slot accounting",
                     f"at {where}: running request {rid!r} maps to "
                     f"worker {worker} slot {slot}, which holds "
                     f"{'nothing' if not s.active else repr(s.request_id)}")
            owned[(worker, slot)] = rid
        for dec in cl.decoders:
            for i, s in enumerate(dec.slots):
                if s.active and (dec.worker_id, i) not in owned:
                    fail("E2 slot accounting",
                         f"at {where}: worker {dec.worker_id} slot {i} "
                         f"active for {s.request_id!r} but neither running "
                         f"nor reserved — leaked slot")
            self._check_pages(dec, where)

    def _check_pages(self, dec, where: str) -> None:
        """Paged-KV invariants over one decoder's allocator (dense
        decoders have no allocator and skip):

        P1  free list ∪ live page tables exactly partitions the pool
            (every allocatable page is free or owned, never both, and the
            trash page 0 never circulates);
        P2  no page is owned by two live slots;
        P3  released (inactive) slots hold zero pages.
        """
        alloc = getattr(dec, "allocator", None)
        if alloc is None:
            return
        fail = self.trace.fail
        wid = dec.worker_id

        held: List[int] = []
        for slot, pages in alloc.owned.items():
            held.extend(pages)
            dups = {p for p in pages if pages.count(p) > 1}
            if dups:
                fail("P2 page double-own",
                     f"at {where}: worker {wid} slot {slot} maps page(s) "
                     f"{sorted(dups)} more than once")
        seen: Dict[int, int] = {}
        for slot, pages in alloc.owned.items():
            for p in pages:
                if p in seen and seen[p] != slot:
                    fail("P2 page double-own",
                         f"at {where}: worker {wid} page {p} owned by both "
                         f"slot {seen[p]} and slot {slot} — one request "
                         f"would decode over another's KV")
                seen[p] = slot

        for slot, pages in alloc.owned.items():
            s = dec.slots[slot] if slot < len(dec.slots) else None
            if s is None or not s.active:
                fail("P3 released-slot pages",
                     f"at {where}: worker {wid} slot {slot} is released "
                     f"but still holds {len(pages)} page(s) "
                     f"{sorted(pages)} — leaked pool capacity")

        free = alloc.free_list()
        if len(set(free)) != len(free):
            fail("P1 page-pool partition",
                 f"at {where}: worker {wid} free list holds duplicates")
        free_set, held_set = set(free), set(held)
        if 0 in free_set or 0 in held_set:
            fail("P1 page-pool partition",
                 f"at {where}: worker {wid} trash page 0 entered "
                 f"circulation")
        both = free_set & held_set
        if both:
            fail("P1 page-pool partition",
                 f"at {where}: worker {wid} page(s) {sorted(both)} are "
                 f"simultaneously free and owned")
        covered = free_set | held_set
        missing = alloc.all_pages() - covered
        extra = covered - alloc.all_pages()
        if missing or extra:
            fail("P1 page-pool partition",
                 f"at {where}: worker {wid} free ∪ owned ≠ pool "
                 f"(missing={sorted(missing)}, foreign={sorted(extra)})")
        if alloc.reserved_pages > len(free):
            fail("P1 page-pool partition",
                 f"at {where}: worker {wid} reservations "
                 f"({alloc.reserved_pages}) exceed the free list "
                 f"({len(free)})")


def attach_engine_sanitizer(cluster) -> EngineSanitizer:
    """Instrument a DisaggregatedCluster in place; returns the sanitizer
    (exposed as ``cluster.sanitizer``)."""
    san = EngineSanitizer(cluster)
    cluster.sanitizer = san
    return san


# ----------------------------------------------------------- control plane --


class ControlPlaneSanitizer:
    """Standalone control-plane checks (I4/I5) after every routing
    decision — for users driving a bare :class:`ControlPlane` without
    either backend's richer sanitizer."""

    def __init__(self, control):
        self.control = control
        self.trace = _Trace()
        self._select = control.select_worker
        control.select_worker = self._wrap_select

    def _wrap_select(self, tokens, **kw):
        out = self._select(tokens, **kw)
        self.trace.add(f"select rid={kw.get('rid')!r} -> worker {out[0]} "
                       f"at now={kw.get('now', 0.0)}")
        divergence = self.control.router.cache_coherent()
        if divergence is not None:
            self.trace.fail("I5 router load-cache coherence", divergence)
        for problem in self.control.router.indexer.audit():
            self.trace.fail("I4 radix tree consistency", problem)
        return out


def attach_control_sanitizer(control) -> ControlPlaneSanitizer:
    san = ControlPlaneSanitizer(control)
    control.sanitizer = san
    return san
