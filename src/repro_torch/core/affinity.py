"""Simhash-bucketed approximate prefix affinity — the O(1) overlap scorer.

The exact KvIndexer scores overlap by walking the radix tree along the
request's chained block hashes.  At production pool sizes that walk is
already aggregated to O(blocks + claims-on-path), but it still touches a
tree; production router stacks (vllm-project/production-stack
``affinity/simhash_affinity.py``) go one step cheaper: hash the request's
*prefix* to a simhash bucket and keep per-bucket worker affinity, so a
routing decision is a dict lookup.

:class:`SimHashAffinity` follows that shape, adapted to this repo's
chained block hashes: the bucket key is a 64-bit bit-voting simhash over
the first ``prefix_blocks`` chained hashes (two prompts share a bucket
iff they share those leading blocks — chained hashes commit to the whole
prefix, so any earlier divergence flips every later feature), and each
bucket maps worker → (deepest fresh insert depth, last touch).  Scoring a
request estimates each worker's overlap as ``min(stored depth,
request blocks) / request blocks``, with the same TTL freshness model as
the indexer.

The approximation is exact whenever requests that share the leading
``prefix_blocks`` blocks share their whole prefix — true for template
workloads (every request of a template has the same prompt), which is
what the exact-agreement test pins on small pools.  It deliberately
over-credits a worker that cached a *long* prompt when a *short* prompt
of the same bucket arrives — the price of never walking the tree.

Signatures are memoized per leading-hash tuple (requests come from a
small template universe, so the 64×features bit-voting loop runs once
per template, not once per decision).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.radix import BLOCK_SIZE, block_hashes

_MASK64 = (1 << 64) - 1
_MIX = 0x9E3779B97F4A7C15          # splitmix64 golden-ratio multiplier


def simhash64(features: Sequence[int]) -> int:
    """Classic bit-voting simhash over integer features: each feature is
    avalanche-mixed to 64 bits, every bit votes ±1, the sign vector is
    the signature.  One feature → its mixed value; similar feature SETS
    → nearby signatures."""
    if not features:
        return 0
    votes = [0] * 64
    for f in features:
        v = ((f & _MASK64) * _MIX) & _MASK64
        v ^= v >> 29
        for b in range(64):
            votes[b] += 1 if (v >> b) & 1 else -1
    sig = 0
    for b in range(64):
        if votes[b] > 0:
            sig |= 1 << b
    return sig


class SimHashAffinity:
    """Bucketed approximate prefix-affinity index.

    ``insert(worker, hashes, now)`` — O(1): bucket the prefix, record the
    worker's insert depth and touch time (deepest fresh depth wins).

    ``overlap_depths(hashes, now)`` — O(bucket): per-worker estimated
    fresh prefix depth for the request's bucket; the router's vectorized
    argmin consumes this exactly like ``KvIndexer.overlap_depths``.

    TTL semantics mirror the indexer: a worker's bucket entry is fresh iff
    touched within ``ttl``; stale entries are dropped on the read that
    discovers them (buckets self-clean instead of accumulating every
    worker that ever touched a popular template)."""

    def __init__(self, block_size: int = BLOCK_SIZE, prefix_blocks: int = 4,
                 ttl: Optional[float] = None):
        self.block_size = block_size
        self.prefix_blocks = prefix_blocks
        self.ttl = ttl
        # signature → {worker: (depth, last_touch)}
        self._buckets: Dict[int, Dict[int, Tuple[int, float]]] = {}
        self._sig_cache: Dict[Tuple[int, ...], int] = {}

    # ------------------------------------------------------------ keying ----

    def signature(self, hashes: Sequence[int]) -> int:
        key = tuple(hashes[:self.prefix_blocks])
        sig = self._sig_cache.get(key)
        if sig is None:
            sig = self._sig_cache[key] = simhash64(key)
        return sig

    # ------------------------------------------------------------ update ----

    def insert(self, worker: int, hashes: Optional[Sequence[int]],
               now: float = 0.0) -> None:
        if not hashes:
            return
        bucket = self._buckets.setdefault(self.signature(hashes), {})
        depth = len(hashes)
        prev = bucket.get(worker)
        if prev is not None and prev[0] > depth \
                and (self.ttl is None or now - prev[1] <= self.ttl):
            depth = prev[0]        # deepest still-fresh insert wins
        bucket[worker] = (depth, now)

    def clear_worker(self, worker: int) -> None:
        """Drain-protocol flush: forget every affinity of ``worker``."""
        for bucket in self._buckets.values():
            bucket.pop(worker, None)

    # ------------------------------------------------------------- query ----

    def overlap_depths(self, hashes: Sequence[int], now: float = 0.0
                       ) -> Dict[int, int]:
        if not hashes:
            return {}
        bucket = self._buckets.get(self.signature(hashes))
        if not bucket:
            return {}
        total = len(hashes)
        out: Dict[int, int] = {}
        stale: List[int] = []
        ttl = self.ttl
        for w, (depth, touch) in bucket.items():
            if ttl is not None and now - touch > ttl:
                stale.append(w)
                continue
            out[w] = depth if depth < total else total
        for w in stale:
            del bucket[w]
        return out

    def overlap_scores(self, tokens: Sequence[int], workers: Sequence[int],
                       now: float = 0.0,
                       hashes: Optional[Sequence[int]] = None) -> List[float]:
        """Dense per-worker overlap fractions — drop-in for
        ``KvIndexer.overlap_scores`` on the router's scalar path."""
        hs = block_hashes(tokens, self.block_size) if hashes is None \
            else hashes
        total = max(len(hs), 1)
        depth = self.overlap_depths(hs, now)
        get = depth.get
        return [get(w, 0) / total for w in workers]
