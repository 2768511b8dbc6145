"""The work a step needs, counted from the configuration's widths and the
lengths the harness knows, whatever implements it.

FLOPs: every matrix product at 2 FLOPs a multiply-add, and attention's two
products (q.k and p.v) over the keys each query sees; the embedding lookup,
norms, RoPE and softmax are not counted.  Bytes: each input byte read once
and each output byte written once.  The peaks are NVIDIA's published
figures (``peaks.json``); a share is stated against them with the card's
power limit beside it."""
from __future__ import annotations

import json
from typing import Iterable, Sequence

from harness.spec import BENCH_DIR

BF16 = 2


def peaks(kind: str) -> dict:
    with open(BENCH_DIR / "harness" / "peaks.json") as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r}: {sorted(table)}")
    return table[kind]


def layer_matmul_params(m: dict) -> int:
    """Weights a token multiplies through in one layer."""
    d, h, k, hd = (m["hidden_size"], m["num_attention_heads"],
                   m["num_key_value_heads"], m["head_dim"])
    f = m["intermediate_size"]
    mlp = (3 if m["hidden_act"] == "silu" else 2) * d * f
    return d * h * hd + 2 * d * k * hd + h * hd * d + mlp


def attention_flops(m: dict, first: int, last: int) -> float:
    """Attention FLOPs of the queries at positions first..last-1 of one
    sequence over all layers; the query at position p sees p + 1 keys."""
    if last <= first:
        return 0.0
    keys = (last * (last + 1) - first * (first + 1)) / 2
    return (4.0 * m["num_attention_heads"] * m["head_dim"] * keys
            * m["num_hidden_layers"])


def prompt_flops(m: dict, start: int, length: int) -> float:
    """A prompt pass computing positions start..length-1 and the logits of
    the last one."""
    n = length - start
    return (2.0 * layer_matmul_params(m) * m["num_hidden_layers"] * n
            + 2.0 * m["hidden_size"] * m["vocab_size"]
            + attention_flops(m, start, length))


def decode_flops(m: dict, positions: Iterable[int]) -> float:
    """One decode step of the slots whose new token sits at ``positions``."""
    per_token = (2.0 * layer_matmul_params(m) * m["num_hidden_layers"]
                 + 2.0 * m["hidden_size"] * m["vocab_size"])
    total = 0.0
    for p in positions:
        total += per_token + attention_flops(m, p, p + 1)
    return total


def decode_attention_bytes(m: dict, lengths: Sequence[int]) -> int:
    """One launch of decode attention over rows of ``lengths`` keys, for one
    layer: the K and V below each length, q and the output, and the lengths
    (int32).  A paged launch reads the same rows through its page table,
    whose entries are counted by :func:`page_table_bytes`."""
    k, hd, h = (m["num_key_value_heads"], m["head_dim"],
                m["num_attention_heads"])
    kv = sum(lengths) * k * hd * 2 * BF16
    return kv + 2 * len(lengths) * h * hd * BF16 + 4 * len(lengths)


def page_table_bytes(lengths: Sequence[int], block: int) -> int:
    return 4 * sum(-(-n // block) for n in lengths)
