"""Weights drawn on the device from the seed, in the type they are served
in (bf16), in the parameter tree the program's ``Model`` takes.

One generator on the device fills one flat buffer in place, in a few
large calls; each leaf is a view of it, scaled in place.  Scales follow the usual
initialisation (0.02 for the embedding, fan-in ** -0.5 for every
projection, 1 for the norms).  The reference reads the same tensors."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30          # elements a call draws


def leaves(m: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every random leaf of a dense GQA model with
    the published sizes ``m`` (a configuration file's ``model``)."""
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


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def make_weights(m: dict, seed: int, device) -> Dict:
    """The parameter tree of the model ``m``, bf16 on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    spec = leaves(m)
    total = sum(torch.Size(s).numel() for _, s, _ in spec)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        buf[lo:hi].normal_(generator=gen)
    d = m["hidden_size"]
    ones = torch.ones(d, dtype=torch.bfloat16, device=device)
    tree = {"layers": [{"attn": {"norm": {"scale": ones}},
                        "mlp": {"norm": {"scale": ones}}}
                       for _ in range(m["num_hidden_layers"])],
            "final_norm": {"scale": ones}}
    at = 0
    for path, shape, scale in spec:
        n = torch.Size(shape).numel()
        leaf = buf[at:at + n].view(shape)
        leaf.mul_(scale)
        _put(tree, path, leaf)
        at += n
    return tree
