"""Nemotron-H: a stack of pre-norm layers of three kinds, set one by one
by ``hybrid_override_pattern``: ``M`` a Mamba-2 mixer (grouped B and C,
the gate before a group-wise RMSNorm), ``-`` a squared-ReLU MLP, ``*``
grouped-query attention without positional encoding; then a final norm and
an untied unembedding.  The program's config is ``"program"``'s entry.

The interface is set out in ``architectures/__init__.py``.  Beside it,
:func:`decode_bytes` gives the least bytes a decode step moves, for the
share of the byte roofline a step reaches."""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

import torch

from architectures import differ
from reference import nemotron_h as reference  # noqa: F401

BF16, FP32 = 2, 4

# The program config's fields (``configs/nemotron_h_47b.py``) and the
# published keys that must equal them.
WIDTH_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "attention_head_dim": "resolved_head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "layer_norm_epsilon": "norm_eps",
    "hybrid_override_pattern": "layer_pattern",
}
SSM_KEYS = {"mamba_head_dim": "head_dim", "n_groups": "n_groups",
            "ssm_state_size": "d_state", "conv_kernel": "d_conv",
            "expand": "expand", "chunk_size": "chunk"}


def mismatches(model: dict, cfg) -> List[str]:
    """Where the program's config ``cfg`` departs from ``model``: every
    width as a number, the pattern as a string, and the forms the
    reference takes (grouped gate-first norm, no RoPE, squared ReLU)."""
    out = []
    for key, attr in WIDTH_KEYS.items():
        out += differ(key, model[key], getattr(cfg, attr, None))
    s = cfg.ssm
    if s is None:
        return out + [f"mamba: file {model['mamba_num_heads']} heads, "
                      "program no Mamba layer"]
    for key, attr in SSM_KEYS.items():
        out += differ(key, model[key], getattr(s, attr, None))
    out += differ("mamba_num_heads", model["mamba_num_heads"],
                  s.expand * cfg.d_model // s.head_dim)
    out += differ("gate_then_norm", True, getattr(s, "gate_then_norm", None))
    out += differ("use_rope", False, getattr(cfg, "use_rope", True))
    act = {"relu2": "squared_relu"}.get(model["mlp_hidden_act"],
                                        model["mlp_hidden_act"])
    out += differ("mlp_hidden_act", act, cfg.activation)
    return out


def _widths(m: dict):
    d = m["hidden_size"]
    h, hp = m["mamba_num_heads"], m["mamba_head_dim"]
    gn = m["n_groups"] * m["ssm_state_size"]
    di = h * hp
    return d, di, h, gn, di + 2 * gn


def leaves(m: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every random leaf, in draw order: the
    embedding (0.02), the unembedding, then each layer's projections at
    fan-in ** -0.5, a Mamba layer's conv weights and bias at 0.3 (the
    standard deviation of PyTorch's default for a 4-tap depthwise conv)."""
    d, di, h, gn, conv = _widths(m)
    v, f = m["vocab_size"], m["intermediate_size"]
    ah, ak, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                  m["attention_head_dim"])
    out = [(("embed",), (v, d), 0.02), (("unembed",), (d, v), d ** -0.5)]
    for i, kind in enumerate(m["hybrid_override_pattern"]):
        if kind == "M":
            p = ("layers", i, "mamba")
            out += [(p + ("w_in",), (d, di + conv + h), d ** -0.5),
                    (p + ("conv_w",), (m["conv_kernel"], conv), 0.3),
                    (p + ("conv_b",), (conv,), 0.3),
                    (p + ("w_out",), (di, d), di ** -0.5)]
        elif kind == "*":
            p = ("layers", i, "attn")
            out += [(p + ("wq",), (d, ah, hd), d ** -0.5),
                    (p + ("wk",), (d, ak, hd), d ** -0.5),
                    (p + ("wv",), (d, ak, hd), d ** -0.5),
                    (p + ("wo",), (ah, hd, d), (ah * hd) ** -0.5)]
        else:
            p = ("layers", i, "mlp")
            out += [(p + ("wu",), (d, f), d ** -0.5),
                    (p + ("wd",), (f, d), f ** -0.5)]
    return out


def skeleton(m: dict, device) -> dict:
    """The tree of the program's ``Model``, in bf16: norm scales 1, and a
    Mamba layer's A_log = log(1..H) (Mamba-2's initialisation), D = 1 and
    dt_bias = softplus⁻¹ of dt log-spaced over [time_step_min,
    time_step_max] across the heads (for the published random draw)."""
    d, di, h, _, _ = _widths(m)
    bf = dict(dtype=torch.bfloat16, device=device)

    def ones(n):
        return {"scale": torch.ones(n, **bf)}
    dt = torch.exp(torch.linspace(math.log(m["time_step_min"]),
                                  math.log(m["time_step_max"]), h,
                                  dtype=torch.float32))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32))
    layers = []
    for kind in m["hybrid_override_pattern"]:
        if kind == "M":
            layers.append({"mamba": {
                "norm": ones(d), "out_norm": ones(di),
                "A_log": a_log.to(**bf), "D": torch.ones(h, **bf),
                "dt_bias": dt_bias.to(**bf)}})
        else:
            layers.append({"attn" if kind == "*" else "mlp":
                           {"norm": ones(d)}})
    return {"layers": layers, "final_norm": ones(d)}


def decode_attention_layers(m: dict) -> int:
    return m["hybrid_override_pattern"].count("*")


def attention_widths(m: dict) -> Tuple[int, int, int]:
    return (m["num_attention_heads"], m["num_key_value_heads"],
            m["attention_head_dim"])


def vocab(m: dict) -> int:
    return m["vocab_size"]


def _matmul_params(m: dict) -> int:
    """Weights a token multiplies through in the layers."""
    d, di, h, gn, conv = _widths(m)
    ah, ak, hd = attention_widths(m)
    per = {"M": d * (di + conv + h) + di * d,
           "*": 2 * d * ah * hd + 2 * d * ak * hd,
           "-": 2 * d * m["intermediate_size"]}
    return sum(per[k] for k in m["hybrid_override_pattern"])


def _scan_flops(m: dict) -> float:
    """The recurrence a token costs over every Mamba layer: per head, the
    state update (dt·B xᵀ added, N·P multiply-adds) and the readout (C·h,
    N·P), at 2 FLOPs a multiply-add, whatever form computes it."""
    _, _, h, _, _ = _widths(m)
    per_head = 4.0 * m["ssm_state_size"] * m["mamba_head_dim"]
    return per_head * h * m["hybrid_override_pattern"].count("M")


def _attention_flops(m: dict, first: int, last: int) -> float:
    """q.k and p.v of the queries at positions first..last-1 of one
    sequence over the attention layers (the query at p sees p + 1 keys)."""
    if last <= first:
        return 0.0
    keys = (last * (last + 1) - first * (first + 1)) / 2
    ah, _, hd = attention_widths(m)
    return 4.0 * ah * hd * keys * decode_attention_layers(m)


def prompt_flops(m: dict, start: int, length: int) -> float:
    """A prompt pass computing positions start..length-1 and the logits of
    the last one."""
    n = length - start
    return (n * (2.0 * _matmul_params(m) + _scan_flops(m))
            + 2.0 * m["hidden_size"] * m["vocab_size"]
            + _attention_flops(m, start, length))


def decode_flops(m: dict, positions: Iterable[int]) -> float:
    """One decode step of the slots whose new token sits at ``positions``."""
    per_token = (2.0 * _matmul_params(m) + _scan_flops(m)
                 + 2.0 * m["hidden_size"] * m["vocab_size"])
    return sum(per_token + _attention_flops(m, p, p + 1) for p in positions)


def _weight_bytes(m: dict) -> int:
    """Every weight a decode step reads, the unembedding and the norms
    included, the embedding table left out (its rows are counted apart)."""
    d, di, h, gn, conv = _widths(m)
    k = m["conv_kernel"]
    mamba = _matmul_params({**m, "hybrid_override_pattern": "M"}) \
        + k * conv + conv + 3 * h + d + di
    per = {"M": mamba, "*": _matmul_params(
        {**m, "hybrid_override_pattern": "*"}) + d,
        "-": _matmul_params({**m, "hybrid_override_pattern": "-"}) + d}
    layers = sum(per[c] for c in m["hybrid_override_pattern"])
    return BF16 * (layers + d * m["vocab_size"] + d)


def state_bytes(m: dict) -> int:
    """One row's recurrent state over every Mamba layer: the fp32 SSM
    state (H, N, P) and the bf16 conv state (K - 1, conv channels)."""
    _, _, h, _, conv = _widths(m)
    per = (FP32 * h * m["ssm_state_size"] * m["mamba_head_dim"]
           + BF16 * (m["conv_kernel"] - 1) * conv)
    return per * m["hybrid_override_pattern"].count("M")


def decode_bytes(m: dict, positions: Iterable[int]) -> int:
    """The least bytes one decode step moves for the live rows whose new
    token sits at ``positions``: every weight read once, each row's
    embedding row read, its recurrent state read and written once, and
    in each attention layer its K and V below the new position read and
    the new position's written."""
    _, ak, hd = attention_widths(m)
    per_key = 2 * ak * hd * BF16 * decode_attention_layers(m)
    total = _weight_bytes(m)
    for p in positions:
        total += (BF16 * m["hidden_size"] + 2 * state_bytes(m)
                  + per_key * (p + 1))
    return total
