"""Datacenter fabric model for P→D KV transfers — the fourth game.

The paper's first three games (prefill placement, KV-tier residency,
cache-affinity routing) price compute and memory; this module prices the
*network*.  Instead of a flat per-block charge, every P→D KV transfer
becomes a sized :class:`Transmission` that serializes store-and-forward
on every :class:`NetworkLink` of its path (Helix's ``NetworkLink`` /
``TransmissionObject`` event model):

    NIC(prefill) ──► rack switch ──► [spine] ──► rack switch ──► NIC(decode)

Topology: one NIC link per worker, one switch link per ``rack_size``
workers, and a single spine link between racks.  Racks are assigned by
worker id (``rack_of(wid) = wid // rack_size``); same-rack transfers skip
the spine.  Because all transfers out of one prefill worker share its
NIC, and all transfers *into* one decode worker share that NIC,
cache-affinity routing that herds requests onto one decode worker
congests exactly the link its KV transfers need — the congestion
externality the fourth game measures.

Two clocks, one model: the analytic simulator pushes a ``transfer_done``
event at ``Transmission.finish_t``; the engine backend settles lazily via
:meth:`Fabric.complete_until`.  Quoting (:meth:`Fabric.quote`) and
committing (:meth:`Fabric.enqueue`) share one scheduling routine, so the
network-aware router's quote replays exactly as the fabric charge
(sanitizer invariant N2).  Per-link byte accounting is integral and
conserved across enqueue/complete/cancel (invariant N1); the drain
protocol cancels in-flight transmissions before re-quoting
(:meth:`Fabric.cancel` refunds the untransmitted residual).

``fabric=None`` everywhere keeps the legacy flat charge, routed through
:func:`kv_hop_seconds` so both backends price the hop in one place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

_GBPS = 1e9 / 8.0                      # bytes/second per Gbit/s


def kv_hop_seconds(per_block_s: float, blocks: float) -> float:
    """Flat (fabric-less) KV-hop charge: ``per_block_s * blocks``.

    The single pricing helper both backends use when no fabric is
    attached.  The engine passes an integral non-resident block count;
    the simulator prices the whole prompt as one block scaled by its
    miss fraction (``blocks = 1 - overlap``) — same unit, coarser grain.
    """
    return per_block_s * blocks


def transfer_block_count(total_blocks: int, overlap: float) -> int:
    """Non-resident 16-token blocks that must cross the wire for a
    request with ``total_blocks`` hashed blocks and cache ``overlap``."""
    if total_blocks <= 0:
        return 0
    return max(0, min(total_blocks,
                      int(round(total_blocks * (1.0 - overlap)))))


@dataclass(frozen=True)
class FabricConfig:
    """Static fabric shape + the network-aware scoring weight.

    Defaults calibrate the *uncongested* full-miss transfer to the
    legacy flat charge: 8 blocks × 5 MiB ≈ 42 MB over a 25 Gbps NIC is
    ~13 ms of NIC serialization — the seed's ``kv_transfer = 0.012``.
    """
    nic_gbps: float = 25.0             # per-worker NIC bandwidth
    rack_gbps: float = 100.0           # intra-rack switch bandwidth
    spine_gbps: float = 100.0          # cross-rack spine bandwidth
    rack_size: int = 8                 # workers per rack (by wid)
    bytes_per_block: int = 5_242_880   # KV bytes per 16-token block
    net_weight: float = 25.0           # router cost units per quoted second


class NetworkLink:
    """One shared link: FIFO store-and-forward serialization.

    ``busy_until`` is the time the link's transmit queue drains;
    ``bytes_inflight`` is the integral sum of sizes of live transmissions
    whose path crosses this link (sanitizer invariant N1 recomputes it).
    """

    __slots__ = ("name", "bandwidth", "busy_until", "bytes_inflight",
                 "bytes_total", "busy_s")

    def __init__(self, name: str, gbps: float):
        self.name = name
        self.bandwidth = gbps * _GBPS          # bytes/second
        self.busy_until = 0.0
        self.bytes_inflight = 0                # live transmissions only
        self.bytes_total = 0                   # cumulative, never refunded
        self.busy_s = 0.0                      # cumulative transmit seconds

    def queue_s(self, now: float) -> float:
        return max(self.busy_until - now, 0.0)


@dataclass
class Transmission:
    """One sized P→D transfer occupying every link on its path."""
    tid: int
    rid: object
    src: int
    dst: int
    n_blocks: int
    size: int                                  # bytes
    path: Tuple[str, ...]
    enqueue_t: float
    finish_t: float
    # per-link (name, start, finish) occupancy, in path order
    segments: Tuple[Tuple[str, float, float], ...] = ()
    done: bool = False
    cancelled: bool = False


class Fabric:
    """Event-clock fabric: topology, live link state, transmissions."""

    def __init__(self, config: FabricConfig, num_decode: int,
                 num_prefill: int):
        self.config = config
        total = num_decode + num_prefill
        self.rack_size = max(1, int(config.rack_size))
        self.num_racks = (total + self.rack_size - 1) // self.rack_size
        self.links: Dict[str, NetworkLink] = {}
        for wid in range(total):
            self.links[f"nic:{wid}"] = NetworkLink(f"nic:{wid}",
                                                   config.nic_gbps)
        for r in range(self.num_racks):
            self.links[f"rack:{r}"] = NetworkLink(f"rack:{r}",
                                                  config.rack_gbps)
        if self.num_racks > 1:
            self.links["spine"] = NetworkLink("spine", config.spine_gbps)
        self.active: Dict[int, Transmission] = {}
        self.enqueued = 0
        self.completed = 0
        self.cancelled = 0
        self._tid = 0
        # uncongested per-byte path inverse-bandwidth (floor pricing)
        c = config
        self._inv_same = 2.0 / (c.nic_gbps * _GBPS) + 1.0 / (c.rack_gbps
                                                             * _GBPS)
        self._inv_cross = (2.0 / (c.nic_gbps * _GBPS)
                           + 2.0 / (c.rack_gbps * _GBPS)
                           + 1.0 / (c.spine_gbps * _GBPS))
        # default pool layout: decode 0..nd-1, prefill nd..nd+np-1 (the
        # simulator's wid convention; role flips call set_pool)
        self.set_pool(tuple(range(num_decode, total)),
                      tuple(range(num_decode)))

    # ------------------------------------------------------- topology --

    def rack_of(self, wid: int) -> int:
        return wid // self.rack_size

    def path(self, src: int, dst: int) -> List[str]:
        if src == dst:
            return []
        rs, rd = self.rack_of(src), self.rack_of(dst)
        if rs == rd:
            return [f"nic:{src}", f"rack:{rs}", f"nic:{dst}"]
        return [f"nic:{src}", f"rack:{rs}", "spine", f"rack:{rd}",
                f"nic:{dst}"]

    def set_pool(self, prefill_ids: Iterable[int],
                 decode_ids: Iterable[int]) -> None:
        """Track the current role split (the Planner flips roles)."""
        self.prefill_ids = tuple(sorted(prefill_ids))
        self.decode_ids = tuple(sorted(decode_ids))
        self._decode_racks = frozenset(self.rack_of(w)
                                       for w in self.decode_ids)

    # ----------------------------------------------------- scheduling --

    def _schedule(self, names: List[str], size: int, now: float):
        """Store-and-forward over ``names``: the message occupies each
        link in order, waiting for that link's queue to drain first.
        Pure given link state — shared by quote and enqueue (N2)."""
        t = now
        segs = []
        for name in names:
            link = self.links[name]
            start = max(t, link.busy_until)
            finish = start + size / link.bandwidth
            segs.append((name, start, finish))
            t = finish
        return t, segs

    def quote(self, src: int, dst: int, n_blocks: int, now: float) -> float:
        """Effective transfer seconds if enqueued now — pure, no commit."""
        if n_blocks <= 0:
            return 0.0
        size = n_blocks * self.config.bytes_per_block
        finish, _ = self._schedule(self.path(src, dst), size, now)
        return finish - now

    def enqueue(self, rid, src: int, dst: int, n_blocks: int,
                now: float) -> Optional[Transmission]:
        """Commit a transfer: reserve every link on the path, return the
        live :class:`Transmission` (``None`` for a fully-warm request)."""
        if n_blocks <= 0:
            return None
        size = n_blocks * self.config.bytes_per_block
        names = self.path(src, dst)
        finish, segs = self._schedule(names, size, now)
        for name, start, fin in segs:
            link = self.links[name]
            link.busy_until = fin
            link.busy_s += fin - start
            link.bytes_inflight += size
            link.bytes_total += size
        self._tid += 1
        txm = Transmission(tid=self._tid, rid=rid, src=src, dst=dst,
                           n_blocks=n_blocks, size=size, path=tuple(names),
                           enqueue_t=now, finish_t=finish,
                           segments=tuple(segs))
        self.active[txm.tid] = txm
        self.enqueued += 1
        return txm

    def complete(self, txm: Transmission) -> None:
        """Settle a finished transmission: release its byte reservation."""
        if txm.done or txm.cancelled:
            return
        txm.done = True
        for name in txm.path:
            self.links[name].bytes_inflight -= txm.size
        del self.active[txm.tid]
        self.completed += 1

    def complete_until(self, now: float) -> None:
        """Lazy settlement for the engine's tick clock."""
        finished = [t for t in self.active.values() if t.finish_t <= now]
        for txm in finished:
            self.complete(txm)

    def cancel(self, txm: Transmission, now: float) -> None:
        """Drain-protocol refund: release the *untransmitted* residual of
        every path segment so a rerouted request re-quotes against link
        state that no longer reserves its old destination (N1)."""
        if txm.done or txm.cancelled:
            return
        txm.cancelled = True
        for name, start, fin in txm.segments:
            link = self.links[name]
            remaining = max(fin - max(now, start), 0.0)
            link.busy_until -= remaining
            link.busy_s -= remaining
            link.bytes_inflight -= txm.size
        del self.active[txm.tid]
        self.cancelled += 1

    # -------------------------------------------------------- pricing --

    def route_src(self, now: float) -> int:
        """Least-queued prefill NIC (lowest wid on ties) — the source
        side of a transfer when the caller doesn't pin one."""
        return min(self.prefill_ids,
                   key=lambda w: (self.links[f"nic:{w}"].queue_s(now), w))

    def floor_seconds(self, src: int, n_blocks: int) -> float:
        """Uncongested (social-optimum) transfer time from ``src`` to the
        nearest decode rack — the per-request OPT column term for the
        network game's counterfactual."""
        if n_blocks <= 0:
            return 0.0
        size = n_blocks * self.config.bytes_per_block
        if not self._decode_racks or self.rack_of(src) in self._decode_racks:
            return size * self._inv_same
        return size * self._inv_cross

    # ------------------------------------------------------ telemetry --

    def link_stats(self, now: float) -> Dict[str, Dict[str, float]]:
        """Per-link queue depth + cumulative utilization for poll_log."""
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(self.links):
            link = self.links[name]
            out[name] = {"queue_s": round(link.queue_s(now), 6),
                         "busy_s": round(link.busy_s, 6),
                         "bytes": link.bytes_total,
                         "inflight": link.bytes_inflight}
        return out

    def freeze(self) -> "FabricSnapshot":
        """Immutable link-state copy for bounded-staleness replica views."""
        return FabricSnapshot(self)


class FabricSnapshot:
    """Frozen fabric state: replica views quote against this snapshot
    (never the live links), so routing on stale link state is exactly as
    stale as the rest of the replica's world (RA011 discipline)."""

    def __init__(self, fabric: Fabric):
        self.config = fabric.config
        self.rack_size = fabric.rack_size
        self.prefill_ids = fabric.prefill_ids
        self._busy = {name: link.busy_until
                      for name, link in fabric.links.items()}
        self._bw = {name: link.bandwidth
                    for name, link in fabric.links.items()}

    def rack_of(self, wid: int) -> int:
        return wid // self.rack_size

    def path(self, src: int, dst: int) -> List[str]:
        if src == dst:
            return []
        rs, rd = self.rack_of(src), self.rack_of(dst)
        if rs == rd:
            return [f"nic:{src}", f"rack:{rs}", f"nic:{dst}"]
        return [f"nic:{src}", f"rack:{rs}", "spine", f"rack:{rd}",
                f"nic:{dst}"]

    def quote(self, src: int, dst: int, n_blocks: int, now: float) -> float:
        if n_blocks <= 0:
            return 0.0
        size = n_blocks * self.config.bytes_per_block
        t = now
        for name in self.path(src, dst):
            start = max(t, self._busy[name])
            t = start + size / self._bw[name]
        return t - now

    def route_src(self, now: float) -> int:
        return min(self.prefill_ids,
                   key=lambda w: (max(self._busy[f"nic:{w}"] - now, 0.0), w))

    def state_key(self) -> Tuple:
        """Hash-free integrity key for sanitizer R2 (snapshot must not
        drift between syncs)."""
        return (self.prefill_ids,
                tuple(sorted(self._busy.items())))
