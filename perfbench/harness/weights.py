"""Weights drawn on the device from the seed, in the type they are served
in (bf16), in the parameter tree the program's model takes.

The architecture (``architectures/<name>.py``) describes the tree: its
random leaves with their scales, and a skeleton holding the deterministic
ones.  One generator on the device fills one flat buffer in place, in a
few large calls; each random leaf is a view of it, scaled in place.  The
reference reads the same tensors."""
from __future__ import annotations

from typing import Dict

import torch

CHUNK = 1 << 30          # elements a call draws


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def make_weights(arch, m: dict, seed: int, device) -> Dict:
    """The parameter tree of the model ``m`` of the architecture ``arch``,
    bf16 on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    spec = arch.leaves(m)
    total = sum(torch.Size(s).numel() for _, s, _ in spec)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        buf[lo:hi].normal_(generator=gen)
    tree = arch.skeleton(m, device)
    at = 0
    for path, shape, scale in spec:
        n = torch.Size(shape).numel()
        leaf = buf[at:at + n].view(shape)
        leaf.mul_(scale)
        _put(tree, path, leaf)
        at += n
    return tree
