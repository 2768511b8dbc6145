"""Radix (prefix) tree over token-block hashes — the KvIndexer.

Tracks which KV cache blocks reside on which workers so the Smart Router can
compute per-worker overlap scores (the positive externality of Game 3).
Blocks are fixed-size token runs; a sequence maps to the list of hashes of
its prefixes, so shared prompt prefixes share leading blocks exactly like
Dynamo's global radix tree.

Large-pool hot path: ``overlap_scores`` does ONE root-to-leaf walk per
request and collects every worker's fresh-prefix depth from the claims on
the path — O(blocks + claims-on-path + workers) instead of the legacy
per-worker walk's O(workers × blocks).  The legacy walk is kept behind
``aggregated=False`` and pinned bit-exact against the aggregated walk over
every pre-existing scenario (tests/test_scale_hotpath.py).

Memory is bounded: nodes carry parent links, invalidation prunes subtrees
that hold no claims, and the ``_node_by_hash`` lookup table shrinks with
the tree instead of growing monotonically.

Claim invariant (prefix closure): a worker's claims always form a
root-connected prefix set — ``insert`` claims whole root-to-leaf paths,
and every invalidation (``remove_worker_block``, ``remove_worker_blocks``,
``clear_worker``) drops the worker's claims on the *entire subtree* below
the invalidated block.  Claims below a dropped block are unreachable by
overlap scoring until the block is re-inserted, and by then the deep KV
may be long demoted — crediting them again on a prefix re-insert was the
router/indexer coherence bug this invariant fixes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

BLOCK_SIZE = 16  # tokens per KV block (vLLM/Dynamo default granularity)


def block_hashes(tokens: Sequence[int], block_size: int = BLOCK_SIZE) -> List[int]:
    """Prefix-chained block hashes: hash_i = H(hash_{i-1}, block_i_tokens)."""
    out: List[int] = []
    h = 0
    n_full = len(tokens) // block_size
    for i in range(n_full):
        blk = tuple(tokens[i * block_size:(i + 1) * block_size])
        h = hash((h,) + blk)
        out.append(h)
    return out


@dataclass
class _Node:
    key: int = 0                       # chained hash (key in parent.children)
    parent: Optional["_Node"] = None
    children: Dict[int, "_Node"] = field(default_factory=dict)
    workers: Dict[int, float] = field(default_factory=dict)  # worker → touch


class KvIndexer:
    """Prefix tree: path = chained block hashes; each node records which
    workers hold that block and when they last touched it.

    ``ttl`` models cache churn: a worker's claim on a block expires if not
    refreshed within ttl seconds (vLLM-style LRU recycling of KV blocks).
    ``ttl=None`` disables expiry (blocks live forever).

    ``aggregated`` selects the single-walk overlap scoring (default); the
    legacy per-worker walk is kept for bit-exactness pinning and perf
    comparison (``benchmarks/bench_scale.py``)."""

    def __init__(self, block_size: int = BLOCK_SIZE,
                 ttl: Optional[float] = None, aggregated: bool = True):
        self.block_size = block_size
        self.ttl = ttl
        self.aggregated = aggregated
        self.root = _Node()
        self._worker_blocks: Dict[int, int] = {}   # worker → claim count
        # Chained hashes are prefix-unique (hash_i commits to the whole
        # prefix), so each hash identifies exactly one tree node — the
        # lookup table single-block invalidation needs.  Entries are
        # dropped when their node is pruned, so the table tracks the live
        # tree instead of every hash ever seen.
        self._node_by_hash: Dict[int, _Node] = {}

    def _fresh(self, node: _Node, worker: int, now: float) -> bool:
        t = node.workers.get(worker)
        if t is None:
            return False
        return self.ttl is None or (now - t) <= self.ttl

    def _cutoff(self, now: float) -> float:
        """Freshness threshold: a claim touched at t is fresh iff
        t >= cutoff (equivalent to the legacy ``now - t <= ttl``)."""
        return float("-inf") if self.ttl is None else now - self.ttl

    # ------------------------------------------------------------ update ----

    def insert(self, worker: int, tokens: Sequence[int], now: float = 0.0,
               hashes: Optional[Sequence[int]] = None):
        hs = block_hashes(tokens, self.block_size) if hashes is None else hashes
        node = self.root
        nbh = self._node_by_hash
        count = self._worker_blocks.get(worker, 0)
        for h in hs:
            child = node.children.get(h)
            if child is None:
                child = _Node(key=h, parent=node)
                node.children[h] = child
                nbh[h] = child
            node = child
            if worker not in node.workers:
                count += 1
            node.workers[worker] = now
        if hs:
            self._worker_blocks[worker] = count

    def _clear_subtree(self, worker: int, top: _Node):
        """Drop ``worker``'s claims on ``top`` and everything below it,
        pruning nodes left with no claims and no children.  Iterative
        (drain-protocol flips after ≥16k-token prompts used to blow the
        recursion limit) and bounded by the worker's claim count: the
        prefix-closure invariant means descending only into claimed
        children visits every claim below ``top``."""
        order = [top]
        stack = [c for c in top.children.values() if worker in c.workers]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(c for c in n.children.values()
                         if worker in c.workers)
        removed = 0
        nbh = self._node_by_hash
        # reversed pre-order processes children before parents, so a chain
        # emptied end-to-end prunes all the way up
        for n in reversed(order):
            if n.workers.pop(worker, None) is not None:
                removed += 1
            if not n.workers and not n.children and n.parent is not None:
                del n.parent.children[n.key]
                nbh.pop(n.key, None)
        node = top.parent
        while (node is not None and node.parent is not None
               and not node.workers and not node.children):
            del node.parent.children[node.key]
            nbh.pop(node.key, None)
            node = node.parent
        if removed:
            left = self._worker_blocks.get(worker, 0) - removed
            if left > 0:
                self._worker_blocks[worker] = left
            else:
                self._worker_blocks.pop(worker, None)

    def remove_worker_block(self, worker: int, block_hash: int):
        """Tier-coherence invalidation: drop ``worker``'s claim on one
        block (identified by its chained hash, e.g. on a KVBM demotion
        out of G1) **and on every block below it**.  Overlap scoring walks
        from the root and stops at the first unclaimed node, so the deeper
        claims are unreachable anyway — but leaving their stale timestamps
        in place meant a later re-insert of just the prefix re-opened the
        walk and credited demoted deep blocks again."""
        node = self._node_by_hash.get(block_hash)
        if node is None:
            return
        self._clear_subtree(worker, node)

    def remove_worker_blocks(self, worker: int, tokens: Sequence[int],
                             hashes: Optional[Sequence[int]] = None):
        """Eviction event: drop this worker from every block of the
        sequence.  Evicting the sequence's first block truncates the
        worker's credited prefix at the root, so (prefix closure) the
        whole subtree behind it is cleared with it."""
        hs = block_hashes(tokens, self.block_size) if hashes is None else hashes
        if not hs:
            return
        node = self.root.children.get(hs[0])
        if node is not None:
            self._clear_subtree(worker, node)

    def clear_worker(self, worker: int):
        """Drop every claim of ``worker`` (Game 1 drain-protocol flush).
        Iterative and bounded by the worker's claim count."""
        for child in list(self.root.children.values()):
            if worker in child.workers:
                self._clear_subtree(worker, child)
        self._worker_blocks.pop(worker, None)

    # ------------------------------------------------------------- query ----

    def matched_blocks(self, worker: int, tokens: Sequence[int],
                       now: float = 0.0,
                       hashes: Optional[Sequence[int]] = None) -> int:
        """Longest fresh prefix (in blocks) of `tokens` cached on `worker`."""
        hs = block_hashes(tokens, self.block_size) if hashes is None else hashes
        node = self.root
        cutoff = self._cutoff(now)
        n = 0
        for h in hs:
            node = node.children.get(h)
            if node is None:
                break
            t = node.workers.get(worker)
            if t is None or t < cutoff:
                break
            n += 1
        return n

    def overlap_scores(self, tokens: Sequence[int], workers: Sequence[int],
                       now: float = 0.0,
                       hashes: Optional[Sequence[int]] = None):
        """o_ij ∈ [0,1]: fresh matched-prefix fraction per worker (Eq. 7).

        Aggregated path: one root-to-leaf walk; at depth i every worker
        whose fresh claims covered blocks 0..i-1 either extends its prefix
        (a fresh claim on this node) or is finished.  Cost is the walk
        plus the claims actually on the path — cold workers cost nothing
        beyond the final output lookup."""
        hs = block_hashes(tokens, self.block_size) if hashes is None else hashes
        total = max(len(hs), 1)
        if not self.aggregated:
            return self._overlap_scores_legacy(hs, workers, now, total)
        depth = self.overlap_depths(hs, now)
        get = depth.get
        return [get(w, 0) / total for w in workers]

    def overlap_depths(self, hashes: Sequence[int], now: float = 0.0
                       ) -> Dict[int, int]:
        """Sparse core of the aggregated walk: fresh contiguous prefix
        depth (in blocks) for every worker with claims on the path —
        workers absent from the result have depth 0.  O(blocks +
        fresh-claims-on-path), independent of pool size; the router's
        vectorized path consumes this directly to skip the dense
        per-worker output list.

        Stale claims encountered on the walk are swept: a TTL-expired
        claim scores zero forever (queries run on the simulator's forward
        clock and only ``insert`` refreshes a claim), so dropping it — and,
        for closure, the worker's whole tail behind it — is invisible to
        scoring but keeps popular chains from accumulating one dead claim
        per worker that ever touched them, which would drag the walk back
        toward O(workers × blocks)."""
        depth: Dict[int, int] = {}
        get = depth.get
        node = self.root
        cutoff = self._cutoff(now)
        i = 0
        for h in hashes:
            node = node.children.get(h)
            if node is None:
                break
            nxt = i + 1
            advanced = 0
            stale = None
            for w, t in node.workers.items():
                if t < cutoff:
                    if stale is None:
                        stale = [w]
                    else:
                        stale.append(w)
                elif get(w, 0) == i:
                    depth[w] = nxt
                    advanced += 1
            if stale:
                for w in stale:
                    self._clear_subtree(w, node)
            if not advanced:
                break   # nobody's prefix reaches this block: deeper nodes
            i = nxt     # cannot extend any contiguous prefix either
        return depth

    def _overlap_scores_legacy(self, hs: Sequence[int],
                               workers: Sequence[int], now: float,
                               total: int):
        """Pre-aggregation per-worker walk, kept verbatim for the
        bit-exactness pin and as the bench_scale comparison baseline."""
        out = []
        for w in workers:
            node = self.root
            n = 0
            for h in hs:
                node = node.children.get(h)
                if node is None or not self._fresh(node, w, now):
                    break
                n += 1
            out.append(n / total)
        return out

    def num_blocks(self, worker: int) -> int:
        return self._worker_blocks.get(worker, 0)

    def snapshot_claims(self, now: float = 0.0) -> Dict[int, Tuple[int, ...]]:
        """Frozen view of every *fresh* claim: block hash → workers whose
        claim on it is fresh at ``now``.  One read-only walk over the whole
        tree (no TTL sweep, unlike ``overlap_depths``) — the bounded-
        staleness replica views snapshot the indexer through this.

        Freshness is prefix-monotone (``insert`` touches a whole
        root-to-leaf path with one timestamp, so a parent is always at
        least as fresh as any child), so the per-hash worker tuples are
        prefix-closed exactly like live claims and a replica can replay
        the ``overlap_depths`` walk against the dict alone."""
        cutoff = self._cutoff(now)
        out: Dict[int, Tuple[int, ...]] = {}
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            ws = tuple(w for w, t in n.workers.items() if t >= cutoff)
            if ws:
                out[n.key] = ws
            stack.extend(n.children.values())
        return out

    def claimed_hashes(self, worker: int) -> List[int]:
        """Audit hook: every block hash ``worker`` currently claims, from
        a read-only tree walk (no TTL sweep — unlike ``overlap_depths``
        this never mutates the tree)."""
        out: List[int] = []
        stack = [c for c in self.root.children.values()
                 if worker in c.workers]
        while stack:
            n = stack.pop()
            out.append(n.key)
            stack.extend(c for c in n.children.values()
                         if worker in c.workers)
        return out

    def audit(self) -> List[str]:
        """Audit hook (``repro.analysis.sanitize``): verify the tree's
        structural invariants by one read-only walk.  Returns a list of
        violation descriptions (empty when consistent).

        Checked: parent links and child keys agree; ``_node_by_hash``
        tracks exactly the live non-root nodes; no unpruned empty node
        (no claims, no children) survives; per-worker claim counts match
        ``_worker_blocks`` exactly (absent == zero); claims are
        prefix-closed (a claim on a node implies a claim on its parent).
        """
        problems: List[str] = []
        counts: Dict[int, int] = {}
        live = 0
        stack = [(self.root, None)]
        while stack:
            node, parent = stack.pop()
            if parent is not None:
                live += 1
                if node.parent is not parent:
                    problems.append(
                        f"node {node.key:#x}: broken parent link")
                if self._node_by_hash.get(node.key) is not node:
                    problems.append(
                        f"node {node.key:#x}: missing/mismatched "
                        f"_node_by_hash entry")
                if not node.workers and not node.children:
                    problems.append(
                        f"node {node.key:#x}: empty node not pruned")
                for w in node.workers:
                    counts[w] = counts.get(w, 0) + 1
                    if parent is not self.root and w not in parent.workers:
                        problems.append(
                            f"node {node.key:#x}: worker {w} claim has no "
                            f"parent claim (prefix closure broken)")
            for key, child in node.children.items():
                if child.key != key:
                    problems.append(
                        f"node under {node.key:#x}: child key {key:#x} != "
                        f"node.key {child.key:#x}")
                stack.append((child, node))
        if live != len(self._node_by_hash):
            problems.append(
                f"_node_by_hash has {len(self._node_by_hash)} entries for "
                f"{live} live nodes (stale entries leak memory)")
        if counts != self._worker_blocks:
            diff = {w: (counts.get(w, 0), self._worker_blocks.get(w, 0))
                    for w in set(counts) | set(self._worker_blocks)
                    if counts.get(w, 0) != self._worker_blocks.get(w, 0)}
            problems.append(
                f"claim counters diverge (worker: actual vs counted) {diff}")
        return problems
