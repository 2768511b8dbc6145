"""The work a step needs, counted from the configuration's widths and the
lengths the harness knows, whatever implements it.

FLOPs are the architecture's (``prompt_flops`` and ``decode_flops`` of
``architectures/<name>.py``): every matrix product at 2 FLOPs a
multiply-add, and attention's two products (q.k and p.v) over the keys each
query sees; the embedding lookup, norms, RoPE and softmax are not counted.
Bytes of decode attention, shared here since they depend only on the
attention widths: each input byte read once and each output byte written
once.  The peaks are NVIDIA's published figures (``peaks.json``); a share
is stated against them with the card's power limit beside it."""
from __future__ import annotations

import json
from typing import Sequence, Tuple

from harness.spec import BENCH_DIR

BF16 = 2


def peaks(kind: str) -> dict:
    with open(BENCH_DIR / "harness" / "peaks.json") as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r}: {sorted(table)}")
    return table[kind]


def decode_attention_bytes(widths: Tuple[int, int, int],
                           lengths: Sequence[int]) -> int:
    """One launch of decode attention over rows of ``lengths`` keys, for one
    layer of the attention ``widths`` (query heads, K/V heads, head size:
    the architecture's ``attention_widths``): the K and V below each
    length, q and the output, and the lengths (int32).  A paged launch
    reads the same rows through its page table, whose entries are counted
    by :func:`page_table_bytes`."""
    h, k, hd = widths
    kv = sum(lengths) * k * hd * 2 * BF16
    return kv + 2 * len(lengths) * h * hd * BF16 + 4 * len(lengths)


def page_table_bytes(lengths: Sequence[int], block: int) -> int:
    return 4 * sum(-(-n // block) for n in lengths)
