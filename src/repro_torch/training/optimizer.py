"""AdamW with global-norm clipping and a linear-warmup cosine schedule: port
of ``src/repro/training/optimizer.py``.

The optimizer state mirrors the parameter tree (nested dicts and lists of
tensors).  Everything is computed in fp32 in the reference's order of
operations.  Unlike the reference, which returns new trees, :func:`update`
writes the new params, moments and step into the tensors it is given (and
returns them): a second copy of a 4 B-parameter model's fp32 state would
not fit beside the first on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree):
    """The tensors of a tree of dicts and lists, dict keys in sorted order
    (the reference's pytree order)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for node in tree:
            yield from leaves(node)
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _stacked_ndims(tree, extra=0):
    """Each leaf's ndim in the reference's layout, in :func:`leaves` order.
    The reference stacks the layers into one array per parameter, so a leaf
    inside the port's list of layers has one axis more there (and a layer's
    norm scale, 1-D here, is 2-D and weight-decayed there)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _stacked_ndims(tree[key], extra)
    elif isinstance(tree, (list, tuple)):
        for node in tree:
            yield from _stacked_ndims(node, extra + 1)
    else:
        yield tree.ndim + extra


def schedule(cfg: OptimizerConfig, step):
    """The learning rate at ``step`` (an int or a tensor), as an fp32
    tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params):
    """fp32 zero moments shaped like ``params`` and an int32 step of 0."""
    device = next(leaves(params)).device

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def update(cfg: OptimizerConfig, params, grads, opt_state):
    """One AdamW step, in place.  Returns (params, opt_state, stats) with
    stats {"grad_norm", "lr"} as 0-d tensors (no host sync)."""
    step = opt_state["step"]
    step.add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    for p, ndim, g, m, v in zip(leaves(params), _stacked_ndims(params),
                                leaves(grads), leaves(opt_state["m"]),
                                leaves(opt_state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        # decoupled weight decay on leaves the reference holds with
        # ndim >= 2: its matrices and every per-layer leaf
        if ndim >= 2:
            upd.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - upd.mul_(lr))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
