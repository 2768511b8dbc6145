"""Disaggregated serving engines on torch: port of
``src/repro/serving/engine.py``.

``PrefillEngine`` runs the prompt pass and emits a per-request KV cache
bundle.  It keeps a block-granular prefix cache keyed by the chained
``block_hashes`` the router and indexer use: when a new prompt shares a
cached prefix, the prompt pass resumes from the matched block boundary
instead of recomputing the prefix.  ``prefill_many`` buckets cold prompts
into right-padded ragged passes and prefix hits into stacked-donor resume
passes, at power-of-two batch widths.

``DecodeEngine`` holds a fixed-slot continuous batch whose per-slot lengths
advance independently.  Finished slots are released inside
:meth:`DecodeEngine.step` (the returned-slot contract: a ``done=True`` tuple
means the slot is already free).  It tracks which KV blocks are resident so
the prefill-to-decode hop is charged per non-resident block.

Differences from the reference, all of mechanism: no ``jit`` (PyTorch runs
eagerly, so ``warmup`` runs each pass once to pay its one-time costs where
the reference compiles it), and caches are updated in place where the
reference donates them.  Every engine runs on ``cuda``
unless the caller passes another ``device``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.radix import BLOCK_SIZE, block_hashes
from repro_torch.models.model import Model
from repro_torch.serving.paging import PageAllocator


def _synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_params(params, device: torch.device) -> None:
    have = params["embed"].device
    if have.type != device.type:
        raise ValueError(f"params live on {have}, the engine runs on {device}")


@dataclass
class PrefillStats:
    """Cumulative prefix-cache + batching accounting (one per engine)."""
    requests: int = 0
    total_blocks: int = 0        # full blocks across all prompts
    reused_blocks: int = 0       # blocks resumed from the prefix cache
    total_tokens: int = 0        # prompt tokens across all prompts
    computed_tokens: int = 0     # suffix tokens actually run through compute
    flops: float = 0.0           # ~ 2*N_active*computed_tokens
    wall_s: float = 0.0          # prompt-pass wall time
    batches: int = 0             # prompt passes issued (any width)
    batched_requests: int = 0    # requests served by a width>1 pass
    padded_tokens: int = 0       # pad tokens run through compute (overhead)

    def as_dict(self) -> dict:
        return dict(requests=self.requests, total_blocks=self.total_blocks,
                    reused_blocks=self.reused_blocks,
                    total_tokens=self.total_tokens,
                    computed_tokens=self.computed_tokens,
                    flops=self.flops, wall_s=self.wall_s,
                    batches=self.batches,
                    batched_requests=self.batched_requests,
                    padded_tokens=self.padded_tokens)


def _row(caches, r: int):
    """Row ``r`` of a cache bundle as a bundle of its own (a copy, so the
    batch bundle it came from can be freed)."""
    return {n: t[:, r:r + 1].clone() for n, t in caches.items()}


class PrefillEngine:
    def __init__(self, model: Model, params, max_len: int,
                 cache_entries: int = 16, block_size: int = BLOCK_SIZE,
                 max_batch: int = 8, device=None):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.block_size = block_size
        self.cache_entries = cache_entries
        self.max_batch = max(1, max_batch)
        # prefix cache: full hash chain of a completed prompt pass -> its
        # cache bundle (K/V valid for every position of that prompt)
        self._cache: "OrderedDict[Tuple[int, ...], dict]" = OrderedDict()
        self.stats = PrefillStats()
        self._flops_per_token = 2.0 * model.cfg.active_param_count()

    def _tokens(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.int32), device=self.device)

    def _prefill(self, tokens: Sequence[int], extras: Optional[dict] = None):
        """The prompt pass of one request; its ``extras`` arrays join the
        batch with a leading batch axis, float64 as float32, as
        ``jnp.asarray`` gives them to the reference (engine.py:229-232)."""
        batch = {"tokens": self._tokens([tokens])}
        for name, value in (extras or {}).items():
            a = np.asarray(value)[None]
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            batch[name] = torch.as_tensor(a, device=self.device)
        return self.model.prefill(self.params, batch, max_len=self.max_len)

    # ------------------------------------------------------ prefix cache ----

    def _best_match(self, hashes: Sequence[int]):
        """``(depth, entry)`` of the deepest common-prefix chain (most
        recently used wins ties); the winner's LRU position is refreshed."""
        best, donor, key = 0, None, None
        for chain in reversed(self._cache):   # most recent first
            m = 0
            for a, b in zip(chain, hashes):
                if a != b:
                    break
                m += 1
            if m > best:
                best, donor, key = m, self._cache[chain], chain
        if key is not None:
            self._cache.move_to_end(key)
        return best, donor

    def _store(self, hashes: Sequence[int], caches) -> None:
        """Keep ``caches`` as the donor of the prompt ``hashes``; only a
        model with resumable prompt passes keeps any (engine.py:353)."""
        if not hashes or self.cache_entries <= 0 \
                or not self.model.supports_prefill_resume:
            return
        key = tuple(hashes)
        self._cache[key] = caches
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_entries:
            self._cache.popitem(last=False)

    def clear_cache(self) -> None:
        self._cache.clear()

    def dummy_caches(self, prompt_len: int):
        """A throwaway cache bundle from a zero-token prompt pass of
        ``prompt_len``, touching neither the prefix cache nor the stats."""
        _, caches = self._prefill([0] * prompt_len)
        return caches

    def _padded_len(self, n: int) -> int:
        """Cold-bucket sequence length: next block multiple when the model
        tolerates right-padding, the exact length otherwise."""
        if self.model.supports_padded_prefill:
            return -(-n // self.block_size) * self.block_size
        return n

    def _width(self, n: int) -> int:
        """Batch width for ``n`` group members: next power of two, capped
        at ``max_batch``."""
        w = 1
        while w < min(n, self.max_batch):
            w *= 2
        return w

    def warmup(self, prompt_lengths: Sequence[int],
               suffix_lengths: Sequence[int] = (),
               batch_sizes: Sequence[int] = (1,)) -> None:
        """Run one of each prompt pass a run will issue, without touching
        the prefix cache or the stats: a cold pass per prompt length, a
        batched pass per (width, padded length), and, on a model with
        resumable prompt passes, a resume per (width, suffix length).
        Where the reference compiles its jitted passes, the port pays its
        one-time costs here (library handles, lazy module loads, allocator
        growth), so measured TTFTs and the saturation detector never see
        them."""
        lengths = sorted(set(int(x) for x in prompt_lengths))
        caches = None
        for n in lengths:
            _, caches = self._prefill([0] * n)
        widths = sorted({self._width(max(1, int(b))) for b in batch_sizes})
        for n in sorted({self._padded_len(x) for x in lengths}):
            for w in widths:
                self.model.prefill_batched(
                    self.params, self._tokens(np.zeros((w, n))),
                    self._tokens(np.ones((w,))), max_len=self.max_len)
        if caches is not None and self.model.supports_prefill_resume:
            n_max = lengths[-1]
            suffixes = [x for x in sorted(set(int(x) for x in suffix_lengths))
                        if 0 < x < n_max]
            for w in widths:
                donor = caches if w == 1 else {
                    n: torch.cat([t] * w, dim=1) for n, t in caches.items()}
                for x in suffixes:
                    self.model.prefill_resume(
                        self.params, donor, self._tokens(np.zeros((w, x))),
                        n_max - x)
        _synchronize(self.device)

    # ----------------------------------------------------------- prefill ----

    def prefill(self, tokens: Sequence[int], extras: Optional[dict] = None,
                hashes: Optional[Sequence[int]] = None):
        """Single-request prompt pass -> (last_logits (V,), cache bundle).

        Resumes from the longest cached block prefix when possible; a miss
        (or a model without resumable prefill, or multimodal ``extras``,
        which is never resumed nor stored) pays the full pass.  Always
        recomputes at least the last token."""
        resumable = (self.model.supports_prefill_resume and not extras
                     and self.cache_entries > 0)
        if hashes is None and resumable:
            hashes = block_hashes(tokens, self.block_size)
        hashes = tuple(hashes or ())
        start = 0
        donor = None
        if resumable and hashes:
            m, donor = self._best_match(hashes)
            # keep >=1 suffix token so the pass emits this prompt's logits
            start = min(m * self.block_size, len(tokens) - 1)
            if start <= 0:
                donor = None
        t0 = time.perf_counter()
        if start > 0:
            logits, caches = self.model.prefill_resume(
                self.params, donor, self._tokens([tokens[start:]]), start)
        else:
            logits, caches = self._prefill(tokens, extras)
        logits = logits[0].cpu().numpy()
        wall = time.perf_counter() - t0
        st = self.stats
        st.requests += 1
        st.total_blocks += len(hashes)
        st.reused_blocks += start // self.block_size
        st.total_tokens += len(tokens)
        st.computed_tokens += len(tokens) - start
        st.flops += self._flops_per_token * (len(tokens) - start)
        st.wall_s += wall
        if resumable:
            self._store(hashes, caches)
        return logits, caches

    # --------------------------------------------------- batched prefill ----

    def prefill_many(self, requests: Sequence[Tuple[Sequence[int],
                                                    Optional[dict],
                                                    Optional[Sequence[int]]]]
                     ) -> List[Tuple[np.ndarray, dict, int]]:
        """Batched prompt passes across queued requests.

        ``requests``: ``(tokens, extras, hashes)`` triples.  Returns, in
        input order, ``(last_logits (V,), cache_bundle, row)``: the
        (possibly shared) batch bundle and the request's row in it, for
        :meth:`DecodeEngine.admit` via ``src_row``.  Prefix-cache hits group
        by (resume start, prompt length) into one stacked-donor resume pass;
        cold prompts bucket by padded length into one right-padded ragged
        pass; identical prompts collapse onto one batch row."""
        n = len(requests)
        results: List[Optional[Tuple[np.ndarray, dict, int]]] = [None] * n
        st = self.stats
        can_resume = self.model.supports_prefill_resume and \
            self.cache_entries > 0
        cold: dict = {}     # padded_len -> [(idx, tokens, hashes)]
        resume: dict = {}   # (start, plen) -> [(idx, tokens, hashes, donor)]
        alias: List[Tuple[int, int]] = []   # (dup idx, primary idx)
        seen: dict = {}     # tokens tuple -> primary idx
        for i, (tokens, extras, hashes) in enumerate(requests):
            if extras:
                # multimodal inputs carry per-request arrays; keep them on
                # the exact single-request path
                logits, caches = self.prefill(tokens, extras, hashes=hashes)
                results[i] = (logits, caches, 0)
                continue
            key = tuple(tokens)
            if key in seen:
                alias.append((i, seen[key]))
                continue
            seen[key] = i
            if hashes is None and can_resume:
                hashes = block_hashes(tokens, self.block_size)
            hashes = tuple(hashes or ())
            start, donor = 0, None
            if can_resume and hashes:
                m, donor = self._best_match(hashes)
                start = min(m * self.block_size, len(tokens) - 1)
                if start <= 0:
                    start, donor = 0, None
            if donor is not None:
                resume.setdefault((start, len(tokens)), []).append(
                    (i, tokens, hashes, donor))
            else:
                cold.setdefault(self._padded_len(len(tokens)), []).append(
                    (i, tokens, hashes))
        for plen, group in cold.items():
            for c0 in range(0, len(group), self.max_batch):
                self._run_cold_chunk(plen, group[c0:c0 + self.max_batch],
                                     results)
        for (start, _), group in resume.items():
            for c0 in range(0, len(group), self.max_batch):
                self._run_resume_chunk(start, group[c0:c0 + self.max_batch],
                                       results)
        for i, j in alias:
            results[i] = results[j]
            st.requests += 1
            st.total_blocks += len(tuple(requests[i][2] or ()))
            st.total_tokens += len(requests[i][0])
        return results

    def _run_cold_chunk(self, plen: int, group, results) -> None:
        w = self._width(len(group))
        toks = np.zeros((w, plen), np.int32)
        lens = np.ones((w,), np.int32)
        for r, (_, tokens, _) in enumerate(group):
            toks[r, :len(tokens)] = tokens
            lens[r] = len(tokens)
        t0 = time.perf_counter()
        logits, caches = self.model.prefill_batched(
            self.params, self._tokens(toks), self._tokens(lens),
            max_len=self.max_len)
        logits = logits.cpu().numpy()
        wall = time.perf_counter() - t0
        st = self.stats
        st.batches += 1
        st.wall_s += wall
        if len(group) > 1:
            st.batched_requests += len(group)
        st.padded_tokens += int(np.sum(plen - lens[:len(group)])) \
            + (w - len(group)) * plen
        for r, (i, tokens, hashes) in enumerate(group):
            st.requests += 1
            st.total_blocks += len(hashes)
            st.total_tokens += len(tokens)
            st.computed_tokens += len(tokens)
            st.flops += self._flops_per_token * len(tokens)
            results[i] = (logits[r], caches, r)
            if hashes and self.cache_entries > 0:
                self._store(hashes, _row(caches, r))

    def _run_resume_chunk(self, start: int, group, results) -> None:
        w = self._width(len(group))
        suffixes = np.stack(
            [np.asarray(tokens[start:], np.int32) for _, tokens, _, _ in group]
            + [np.asarray(group[0][1][start:], np.int32)] * (w - len(group)))
        donors = [d for *_, d in group] + [group[0][3]] * (w - len(group))
        stacked = donors[0] if w == 1 else {
            n: torch.cat([d[n] for d in donors], dim=1) for n in donors[0]}
        t0 = time.perf_counter()
        logits, caches = self.model.prefill_resume(
            self.params, stacked, self._tokens(suffixes), start)
        logits = logits.cpu().numpy()
        wall = time.perf_counter() - t0
        st = self.stats
        st.batches += 1
        st.wall_s += wall
        if len(group) > 1:
            st.batched_requests += len(group)
        st.padded_tokens += (w - len(group)) * suffixes.shape[1]
        for r, (i, tokens, hashes, _) in enumerate(group):
            st.requests += 1
            st.total_blocks += len(hashes)
            st.reused_blocks += start // self.block_size
            st.total_tokens += len(tokens)
            st.computed_tokens += len(tokens) - start
            st.flops += self._flops_per_token * (len(tokens) - start)
            results[i] = (logits[r], caches, r)
            if hashes:
                self._store(hashes, _row(caches, r))


@dataclass
class Slot:
    active: bool = False
    request_id: Optional[str] = None
    length: int = 0
    generated: List[int] = field(default_factory=list)
    max_new: int = 0


PAGED_IMPLS = ("paged", "paged_sdpa")


class DecodeEngine:
    """Fixed-slot continuous batcher around the ragged decode step.

    ``decode_impl``: ``"pallas"`` (default; in the port it selects the
    hand-written CUDA decode kernel) or ``"sdpa"`` (the plain path) over a
    dense per-slot ``max_len`` cache; ``"paged"`` (the CUDA paged kernel) or
    ``"paged_sdpa"`` (gather, then the plain path) over a global page pool
    of ``num_pages`` KV blocks and a per-slot page table.  The paged layout
    gates admission on free pages, grows a slot's table when generation
    crosses a block boundary, and returns the pages on release.
    ``num_pages=None`` sizes the pool to the dense worst case."""

    def __init__(self, model: Model, params, num_slots: int, max_len: int,
                 worker_id: int = 0, resident_blocks: int = 4096,
                 decode_impl: str = "pallas",
                 num_pages: Optional[int] = None,
                 page_block: int = BLOCK_SIZE, device=None):
        if decode_impl not in ("pallas", "sdpa") + PAGED_IMPLS:
            raise ValueError(f"unknown decode_impl {decode_impl!r}")
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.worker_id = worker_id
        self.decode_impl = decode_impl
        self.paged = decode_impl in PAGED_IMPLS
        self.slots = [Slot() for _ in range(num_slots)]
        self.tokens = np.zeros((num_slots, 1), np.int32)
        if self.paged:
            if not model.supports_paged_decode:
                raise ValueError(
                    f"{model.cfg.name} has non-attention mixers; paged KV "
                    "needs a pure causal-attention stack")
            self.page_block = page_block
            self.max_pages_per_slot = -(-max_len // page_block)
            if num_pages is None:
                num_pages = num_slots * self.max_pages_per_slot
            self.allocator = PageAllocator(num_pages, page_block)
            self.caches = model.paged_cache_init(num_pages, page_block,
                                                 self.device)
            # the table starts one page wide and widens along the
            # power-of-two ladder as slots grow; unmapped entries stay 0,
            # the trash page
            self.page_table = np.zeros((num_slots, 1), np.int32)
        else:
            self.allocator = None
            self.caches = model.cache_init(num_slots, max_len, self.device)
        # KV-block residency: bounded LRU over the block hashes this worker
        # has admitted; the hop is charged only for blocks not in it
        self.resident_cap = resident_blocks
        self._resident: "OrderedDict[int, None]" = OrderedDict()
        self.transferred_blocks = 0      # cumulative non-resident blocks

    # -------------------------------------------------------------- admit ---

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    def _touch_blocks(self, hashes: Sequence[int]) -> int:
        """Mark ``hashes`` resident (LRU refresh); returns the number of
        blocks that were NOT already resident: the transfer payload."""
        new = 0
        for h in hashes:
            if h in self._resident:
                self._resident.move_to_end(h)
            else:
                self._resident[h] = None
                new += 1
        while len(self._resident) > self.resident_cap:
            self._resident.popitem(last=False)
        return new

    # ------------------------------------------------------------- paging ---

    def pages_for_request(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page count of a request: prompt + every generated
        token + the admission first-token write, capped by ``max_len``."""
        total = min(prompt_len + max_new + 1, self.max_len)
        return self.allocator.pages_for(total)

    def pages_for_prompt(self, prompt_len: int) -> int:
        """Pages mapped at admit time: the prompt plus one position for the
        first generated token's KV write."""
        return self.allocator.pages_for(min(prompt_len + 1, self.max_len))

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Dense layouts admit on slots alone; the paged layout also needs
        the request's worst-case page count to be coverable."""
        if not self.paged:
            return True
        return self.allocator.can_admit(
            self.pages_for_request(prompt_len, max_new))

    def _table_width(self, n_pages: int) -> int:
        """Page-table width holding ``n_pages``: next power of two, capped
        at the ``max_len`` worst case."""
        w = 1
        while w < n_pages:
            w *= 2
        return min(w, self.max_pages_per_slot)

    def width_ladder(self, total_tokens: Optional[int] = None) -> List[int]:
        """Every page-table width a run can emit, widest bounded by
        ``total_tokens`` (None = the ``max_len`` worst case)."""
        top = self.max_pages_per_slot if total_tokens is None else \
            self._table_width(self.allocator.pages_for(
                min(total_tokens, self.max_len)))
        ladder, w = [], 1
        while w < top:
            ladder.append(w)
            w *= 2
        ladder.append(top)
        return ladder

    def _widen_table(self, width: int) -> None:
        if width > self.page_table.shape[1]:
            pad = width - self.page_table.shape[1]
            self.page_table = np.pad(self.page_table, ((0, 0), (0, pad)))

    def kv_bytes_held(self) -> int:
        """KV bytes committed to requests: dense layouts commit every
        slot's ``max_len`` rows; the paged pool only mapped pages."""
        if self.paged:
            tokens = self.allocator.used_pages * self.page_block
        else:
            tokens = self.num_slots * self.max_len
        return tokens * kv_token_bytes(self.model)

    def pool_utilization(self) -> float:
        """Fraction of the page pool mapped to live slots (dense: 1)."""
        if not self.paged:
            return 1.0
        return self.allocator.used_pages / max(1, self.allocator.num_pages)

    # -------------------------------------------------------------- admit ---

    def reserve(self, slot: int, request_id: str,
                prompt_len: Optional[int] = None,
                max_new: int = 0) -> None:
        """Claim ``slot`` before the request's prefill has run; on a paged
        engine, ``prompt_len`` also reserves the worst-case page count.
        :meth:`step` skips the slot until :meth:`admit` lands."""
        s = self.slots[slot]
        if s.active:
            raise RuntimeError(f"slot {slot} is held by {s.request_id!r}")
        if self.paged and prompt_len is not None:
            if not self.allocator.reserve(
                    slot, self.pages_for_request(prompt_len, max_new)):
                raise RuntimeError(
                    f"slot {slot}: reserve() without a can_admit() gate")
        s.active = True
        s.request_id = request_id

    def admit(self, slot: int, request_id: str, prefill_caches,
              first_token: int, prompt_len: int, max_new: int,
              hashes: Sequence[int] = (), src_row: int = 0) -> int:
        """Move row ``src_row`` of a prefill cache bundle into ``slot`` (the
        prefill-to-decode hop).  Returns the number of non-resident blocks
        the hop moved.  Paged engines map the prompt's pages (plus one
        position for the first token's write) and scatter the KV into them;
        an ungated paged admit raises."""
        if self.paged:
            n_map = self.pages_for_prompt(prompt_len)
            pages = self.allocator.admit(
                slot, n_map, self.pages_for_request(prompt_len, max_new))
            if pages is None:
                raise RuntimeError(
                    f"page pool exhausted admitting {request_id!r} to slot "
                    f"{slot}: gate admission on can_admit()")
            self._widen_table(self._table_width(len(pages)))
            self.page_table[slot, :] = 0
            self.page_table[slot, :len(pages)] = pages
            adopt_prefill_pages(self.caches, prefill_caches, src_row,
                                torch.as_tensor(pages, device=self.device),
                                block=self.page_block)
        else:
            _insert_cache(self.caches, prefill_caches, slot, src_row=src_row)
        s = self.slots[slot]
        s.active = True
        s.request_id = request_id
        s.length = prompt_len
        s.generated = [int(first_token)]
        s.max_new = max_new
        self.tokens[slot, 0] = first_token
        moved = self._touch_blocks(hashes)
        self.transferred_blocks += moved
        return moved

    def release(self, slot: int):
        if self.paged:
            self.allocator.release(slot)
            self.page_table[slot, :] = 0
        self.slots[slot] = Slot()
        self.tokens[slot, 0] = 0

    @property
    def active_count(self) -> int:
        return sum(s.active for s in self.slots)

    def warmup(self, table_widths: Optional[Sequence[int]] = None) -> None:
        """Run the decode step once with every slot inactive (lengths
        zero; whatever the pass writes is overwritten at the next
        ``admit``, and a paged pass writes only the trash page).

        On a paged engine, once per width in ``table_widths`` (see
        :meth:`width_ladder`) and once at the live table's width, which
        stays as it is.  Where the reference compiles the step per width,
        the port pays each width's first launch here."""
        lengths = torch.zeros((self.num_slots,), dtype=torch.int32,
                              device=self.device)
        tokens = torch.as_tensor(self.tokens, device=self.device)
        if not self.paged:
            self.model.decode(self.params, self.caches, tokens, lengths,
                              decode_impl=self.decode_impl)
        else:
            widths = sorted({int(w) for w in (table_widths or ())}
                            | {self.page_table.shape[1]})
            for w in widths:
                table = torch.zeros((self.num_slots, w), dtype=torch.int32,
                                    device=self.device)
                self.model.decode(self.params, self.caches, tokens, lengths,
                                  decode_impl=self.decode_impl,
                                  page_table=table)
        _synchronize(self.device)

    # --------------------------------------------------------------- step ---

    def step(self) -> List[Tuple[str, int, bool]]:
        """One batched decode tick.  Returns [(request_id, token, done)].

        Returned-slot contract: when ``done`` is True the slot has already
        been released inside this step; callers must NOT release it."""
        if not any(s.active and s.generated for s in self.slots):
            return []
        # reserved-but-unadmitted slots decode as length-0 rows and their
        # output is skipped below
        lengths = torch.as_tensor(
            np.asarray([s.length if s.active else 0 for s in self.slots],
                       np.int32), device=self.device)
        tokens = torch.as_tensor(self.tokens, device=self.device)
        table = None
        if self.paged:
            # growth pre-pass: this tick writes each admitted slot's KV at
            # position s.length; map one page from the slot's reservation
            # when that crosses into an unmapped block
            for i, s in enumerate(self.slots):
                if not s.active or not s.generated:
                    continue
                j = s.length // self.page_block
                if j >= len(self.allocator.owned[i]):
                    page = self.allocator.grow(i)
                    self._widen_table(self._table_width(j + 1))
                    self.page_table[i, j] = page
            table = torch.as_tensor(self.page_table, device=self.device)
        logits, self.caches = self.model.decode(
            self.params, self.caches, tokens, lengths,
            decode_impl=self.decode_impl, page_table=table)
        # torch.argmax returns the first maximal index, as np.argmax does
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        out = []
        for i, s in enumerate(self.slots):
            if not s.active or not s.generated:
                continue
            tok = int(nxt[i])
            s.generated.append(tok)
            s.length += 1
            self.tokens[i, 0] = tok
            done = (len(s.generated) >= s.max_new + 1
                    or s.length >= self.max_len - 1)
            out.append((s.request_id, tok, done))
            if done:
                self.release(i)   # slot is re-admittable this same tick
        return out


def kv_token_bytes(model: Model) -> int:
    """KV bytes per cached token position (the self-attention layers, K
    and V, bf16); a recurrent mixer's state and a cross layer's encoder
    K/V do not grow with the length (engine.py:722-727)."""
    cfg = model.cfg
    n_attn = model.mixers.count("attn")
    return 2 * n_attn * cfg.num_kv_heads * cfg.resolved_head_dim * 2


def adopt_prefill_pages(pool, bundle, src_row: int, page_ids, *, block: int):
    """Scatter row ``src_row`` of a prefill cache bundle into freshly mapped
    pool pages, in place.

    ``pool``: paged caches (leaves ``(P, N, block, K, hd)``); ``bundle``:
    prefill caches (leaves ``(P, B, S, K, hd)``); ``page_ids``: (n,) int
    destination pages.  The row's first ``n * block`` positions land in the
    pages in order, right-padded with zeros where the bundle is shorter
    (positions past the prompt are masked by length and overwritten by
    decode before any query reaches them)."""
    n = page_ids.shape[0]
    need = n * block
    for name, dst in pool.items():
        src = bundle[name][:, src_row, :need]          # (P, <=need, K, hd)
        if src.shape[1] < need:
            pad = src.new_zeros((src.shape[0], need - src.shape[1],
                                 *src.shape[2:]))
            src = torch.cat([src, pad], dim=1)
        dst[:, page_ids.long()] = src.reshape(
            src.shape[0], n, block, *src.shape[2:]).to(dst.dtype)


def _insert_cache(dst, src, slot: int, src_row: int = 0):
    """Write row ``src_row`` of a prefill cache bundle into decode slot
    ``slot`` in place, leaf by leaf (every leaf has the layer at axis 0 and
    the batch at axis 1).  A K/V leaf whose prefill sequence axis is
    shorter is zero-padded on the right; a state leaf is copied whole, its
    ``-inf`` stabilisers included."""
    for name, d in dst.items():
        s = src[name][:, src_row]                      # (P, ...)
        if s.shape[1:] == d.shape[2:]:
            d[:, slot] = s.to(d.dtype)
            continue
        d[:, slot, :s.shape[1]] = s.to(d.dtype)
        d[:, slot, s.shape[1]:] = 0
