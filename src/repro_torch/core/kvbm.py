"""Hierarchical KV Block Manager (Game 2's mechanism).

Four tiers — G1 GPU HBM, G2 CPU DRAM, G3 local SSD, G4 networked storage —
with the paper's frequency-based eviction policy (§2.2): every block's
frequency starts at 1, doubles on cache hit, and decays by 1 per time-decay
step; blocks with frequency ≥ 2 are promotion-eligible.  Tier access costs
follow Eq. 6 (α_G1 < α_G2 < α_G3 < γ recompute).

``capacity_ratio`` ρ = active blocks / G1 capacity drives the Prop. 5 regime
transition (PoA_KV = 1 below ρ=1; contested above).

Blocks backing an in-flight decode are *pinned* (reference-counted): the
eviction policy never demotes them, so under pin pressure G1 can run over
capacity — that over-subscription is exactly the ρ > 1 contested regime.
``on_g1_evict`` fires whenever a block leaves G1 (demotion or free), the
hook the serving layer uses to keep router overlap claims coherent with
actual HBM residency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

TIERS = ("G1", "G2", "G3", "G4")

# Eq. 6 cost constants (seconds per block access) — α_G1 < α_G2 < α_G3 < γ.
TIER_COST = {"G1": 0.0001, "G2": 0.001, "G3": 0.010, "G4": 0.050}
RECOMPUTE_COST = 0.100  # γ — block not cached anywhere


@dataclass
class Block:
    block_id: int
    tier: str
    frequency: float = 1.0
    size: int = 1
    pin_count: int = 0
    seq: int = 0         # allocation order; chains allocate root→leaf
    last_touch: float = 0.0   # last allocate/access time (cache-churn age)


class KVBlockManager:
    """Per-worker hierarchical cache."""

    def __init__(self, capacity: Dict[str, int], worker_id: int = 0,
                 on_g1_evict: Optional[Callable[[int], None]] = None):
        # G4 effectively unbounded
        self.capacity = {"G1": capacity.get("G1", 1024),
                         "G2": capacity.get("G2", 4096),
                         "G3": capacity.get("G3", 16384),
                         "G4": capacity.get("G4", 1 << 40)}
        self.worker_id = worker_id
        self.on_g1_evict = on_g1_evict
        self.blocks: Dict[int, Block] = {}
        self.tier_usage = {t: 0 for t in TIERS}
        self.evictions = 0
        self.promotions = 0
        self.demotions = 0
        self._seq = 0

    # ------------------------------------------------------------- admit ----

    def allocate(self, block_id: int, now: float = 0.0) -> str:
        """New block: admit to G1, evicting (demoting) as needed."""
        if block_id in self.blocks:
            return self.access(block_id, now)
        self._make_room("G1")
        self._seq += 1
        blk = Block(block_id, "G1", frequency=1.0, seq=self._seq,
                    last_touch=now)
        self.blocks[block_id] = blk
        self.tier_usage["G1"] += 1
        return "G1"

    def access(self, block_id: int, now: float = 0.0) -> str:
        """Cache hit: double frequency; promote if eligible (freq ≥ 2).

        Frequency is floored back to 1 before doubling (§2.2: "frequency
        starts at 1, doubles on hit") — without the floor a fully-decayed
        block stays at 0×2=0 forever, permanently ineligible for promotion
        and the eternal eviction victim."""
        blk = self.blocks.get(block_id)
        if blk is None:
            return "MISS"
        blk.last_touch = max(blk.last_touch, now)
        blk.frequency = max(blk.frequency, 1.0) * 2.0
        if blk.tier != "G1" and blk.frequency >= 2.0:
            self._promote(blk)
        return blk.tier

    def onboard(self, block_id: int) -> str:
        """Fetch a resident block into G1 HBM (§8.4 onboarding): promote
        through the hierarchy until it is G1-resident, making room as
        needed.  Decode requires HBM residency, so admission onboards
        every block of the request — a no-op for blocks already in G1."""
        blk = self.blocks.get(block_id)
        if blk is None:
            return "MISS"
        while blk.tier != "G1":
            self._promote(blk)
        return blk.tier

    def admit_blocks(self, block_ids, now: float = 0.0):
        """Admission hot path: allocate-or-touch, pin, and onboard every
        block of a request in one pass — one dict probe per block instead
        of the four of ``allocate``/``access``/``pin``/``onboard``.
        Step-for-step identical to that call sequence (same frequency
        doublings, same promotion order, hence the same victim choices),
        just without re-resolving the block each time."""
        blocks = self.blocks
        for bid in block_ids:
            blk = blocks.get(bid)
            if blk is None:
                # allocate() then access() on the fresh G1 block: the
                # access doubles the starting frequency, nothing promotes
                self._make_room("G1")
                self._seq += 1
                blk = Block(bid, "G1", frequency=2.0, seq=self._seq,
                            pin_count=1, last_touch=now)
                blocks[bid] = blk
                self.tier_usage["G1"] += 1
                continue
            # allocate() on a resident block is an access(); admission
            # then accesses again — two doublings, each promoting one
            # tier when the block sits below G1
            for _ in range(2):
                blk.last_touch = max(blk.last_touch, now)
                blk.frequency = max(blk.frequency, 1.0) * 2.0
                if blk.tier != "G1":
                    self._promote(blk)
            blk.pin_count += 1
            while blk.tier != "G1":   # onboard(): decode needs HBM
                self._promote(blk)

    def access_cost(self, block_id: int) -> float:
        blk = self.blocks.get(block_id)
        if blk is None:
            return RECOMPUTE_COST
        return TIER_COST[blk.tier]

    def free(self, block_id: int):
        blk = self.blocks.pop(block_id, None)
        if blk is not None:
            self.tier_usage[blk.tier] -= 1
            if blk.tier == "G1" and self.on_g1_evict is not None:
                self.on_g1_evict(block_id)

    # ----------------------------------------------------------- pinning ----

    def pin(self, block_id: int):
        """Reference-count a block backing an in-flight decode: pinned
        blocks are never demoted out of their tier."""
        blk = self.blocks.get(block_id)
        if blk is not None:
            blk.pin_count += 1

    def unpin(self, block_id: int):
        blk = self.blocks.get(block_id)
        if blk is not None and blk.pin_count > 0:
            blk.pin_count -= 1

    # ------------------------------------------------------------ policy ----

    def decay(self):
        """One time-decay step: every block's frequency decreases by 1."""
        for blk in self.blocks.values():
            blk.frequency = max(blk.frequency - 1.0, 0.0)

    def _victim(self, tier: str) -> Optional[Block]:
        cands = [b for b in self.blocks.values()
                 if b.tier == tier and b.pin_count == 0]
        if not cands:
            return None
        # Equal-frequency ties evict the deepest (most recently allocated)
        # block first — radix caches evict leaves, keeping the surviving
        # prefix contiguous and therefore onboardable.
        return min(cands, key=lambda b: (b.frequency, -b.seq))

    def _make_room(self, tier: str):
        # When every resident block is pinned there is no victim: the tier
        # runs over capacity (pinned decode state cannot be dropped) — the
        # over-subscribed ρ > 1 regime of Prop. 5.
        while self.tier_usage[tier] >= self.capacity[tier]:
            victim = self._victim(tier)
            if victim is None:
                return
            self._demote(victim)

    def _demote(self, blk: Block):
        idx = TIERS.index(blk.tier)
        if idx + 1 >= len(TIERS):
            self.free(blk.block_id)
            self.evictions += 1
            return
        src = blk.tier
        nxt = TIERS[idx + 1]
        self._make_room(nxt)
        self.tier_usage[blk.tier] -= 1
        blk.tier = nxt
        self.tier_usage[nxt] += 1
        self.demotions += 1
        if nxt != "G1":
            self.evictions += 1
        if src == "G1" and self.on_g1_evict is not None:
            self.on_g1_evict(blk.block_id)

    def _promote(self, blk: Block):
        idx = TIERS.index(blk.tier)
        tgt = TIERS[idx - 1]
        self._make_room(tgt)
        self.tier_usage[blk.tier] -= 1
        blk.tier = tgt
        self.tier_usage[tgt] += 1
        self.promotions += 1

    # ------------------------------------------------------------ audit -----

    def audit(self) -> list:
        """Audit hook (``repro.analysis.sanitize``): verify the manager's
        internal accounting by one read-only pass over the block table.
        Returns a list of violation descriptions (empty when consistent).

        Checked: every block sits in a known tier; ``tier_usage`` matches
        a recount of the block table; no negative pin counts.  (A tier
        over capacity is *not* flagged: over-subscription is legal under
        pin pressure — Prop. 5's ρ > 1 regime — and transiently after an
        unpin until the next admission makes room.)"""
        problems = []
        usage = {t: 0 for t in TIERS}
        for bid, blk in self.blocks.items():
            if blk.tier not in usage:
                problems.append(f"block {bid:#x}: unknown tier {blk.tier!r}")
                continue
            usage[blk.tier] += 1
            if blk.pin_count < 0:
                problems.append(
                    f"block {bid:#x}: negative pin_count {blk.pin_count}")
        for t in TIERS:
            if usage[t] != self.tier_usage[t]:
                problems.append(
                    f"tier {t}: tier_usage says {self.tier_usage[t]}, "
                    f"recount finds {usage[t]}")
        return problems

    # ------------------------------------------------------------ stats -----

    def capacity_ratio(self) -> float:
        """ρ of Prop. 5: active blocks vs G1 capacity."""
        return len(self.blocks) / max(self.capacity["G1"], 1)

    def tier_distribution(self) -> Dict[str, int]:
        return dict(self.tier_usage)
