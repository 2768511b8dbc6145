"""Dense GQA: a stack of pre-norm blocks, each grouped-query attention
with RoPE and a SwiGLU or squared-ReLU MLP, then a final norm and an
untied unembedding (Phi-4-mini, Minitron-4B).  The program's config comes
from its registry.

The interface is set out in ``architectures/__init__.py``."""
from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from architectures import differ
from reference import dense_gqa as reference  # noqa: F401

# The registry config's fields and the published keys that must equal them.
WIDTH_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
}
ACTIVATIONS = {"silu": "swiglu", "relu2": "squared_relu"}


def mismatches(model: dict, cfg) -> List[str]:
    """Where the program's config ``cfg`` departs from the widths in
    ``model`` (empty when they agree).  Keeps a later edit of the
    program's config file from moving the yardstick unseen."""
    out = []
    for key, attr in WIDTH_KEYS.items():
        have = getattr(cfg, attr)
        if attr == "head_dim":
            have = cfg.resolved_head_dim
        out += differ(key, model[key], have)
    act = ACTIVATIONS.get(model["hidden_act"], model["hidden_act"])
    if cfg.activation != act:
        out.append(f"hidden_act: file {model['hidden_act']}, "
                   f"program {cfg.activation}")
    return out


def leaves(m: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every random leaf of a dense GQA model with
    the published sizes ``m`` (a configuration file's ``model``).  Scales
    follow the usual initialisation: 0.02 for the embedding, fan-in **
    -0.5 for every projection."""
    d, v = m["hidden_size"], m["vocab_size"]
    h, k, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    f = m["intermediate_size"]
    out = [(("embed",), (v, d), 0.02), (("unembed",), (d, v), d ** -0.5)]
    for i in range(m["num_hidden_layers"]):
        a, p = ("layers", i, "attn"), ("layers", i, "mlp")
        out += [(a + ("wq",), (d, h, hd), d ** -0.5),
                (a + ("wk",), (d, k, hd), d ** -0.5),
                (a + ("wv",), (d, k, hd), d ** -0.5),
                (a + ("wo",), (h, hd, d), (h * hd) ** -0.5)]
        if m["hidden_act"] == "silu":
            out.append((p + ("wg",), (d, f), d ** -0.5))
        out += [(p + ("wu",), (d, f), d ** -0.5),
                (p + ("wd",), (f, d), f ** -0.5)]
    return out


def skeleton(m: dict, device) -> dict:
    """The tree of the program's ``Model``, its norm scales 1 in bf16."""
    d = m["hidden_size"]
    ones = torch.ones(d, dtype=torch.bfloat16, device=device)
    return {"layers": [{"attn": {"norm": {"scale": ones}},
                        "mlp": {"norm": {"scale": ones}}}
                       for _ in range(m["num_hidden_layers"])],
            "final_norm": {"scale": ones}}


def decode_attention_layers(m: dict) -> int:
    return m["num_hidden_layers"]


def attention_widths(m: dict) -> Tuple[int, int, int]:
    return (m["num_attention_heads"], m["num_key_value_heads"],
            m["head_dim"])


def vocab(m: dict) -> int:
    return m["vocab_size"]


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
