"""Token-choice top-k Mixture-of-Experts on torch: port of
``src/repro/models/moe.py``.

Each token goes to its top-k experts (plus Arctic's optional dense
residual).  Dispatch is sort-based at a fixed capacity: each token is
replicated k times, the (token, expert) rows are stably sorted by expert
id, row r of expert e lands in slot ``e * capacity + r``, and rows past
capacity are dropped.  The batched expert products run on the (E, capacity,
d) buffer, and the rows are scattered back, unsorted and weighted.

Where the reference shards the dispatch into one group per data shard
(``_dispatch_groups``, moe.py:47-58), the port takes one group: it has no
sharding policy yet (ROADMAP item "Sharding"), and with none the reference
takes one group too and its ``shard(...)`` calls are the identity, so they
are left out here.

Parameters are plain dicts of tensors with the reference's names and
layouts; functions take an explicit ``torch.Generator`` and device, as
``layers.py`` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, _init, rmsnorm, rmsnorm_init


def moe_init(generator, cfg, dtype, device):
    """The reference's leaves and scales (moe.py:23-40), drawn from
    ``generator`` on ``device`` one leaf at a time."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {
        "norm": rmsnorm_init(d, dtype, device),
        "wr": _init(generator, (d, e), d ** -0.5, dtype, device),
        "wu": _init(generator, (e, d, f), d ** -0.5, dtype, device),
        "wd": _init(generator, (e, f, d), f ** -0.5, dtype, device),
    }
    if cfg.activation == "swiglu":
        p["wg"] = _init(generator, (e, d, f), d ** -0.5, dtype, device)
    if m.dense_residual:
        fd = m.d_ff_dense
        p["du"] = _init(generator, (d, fd), d ** -0.5, dtype, device)
        p["dd"] = _init(generator, (fd, d), fd ** -0.5, dtype, device)
        if cfg.activation == "swiglu":
            p["dg"] = _init(generator, (d, fd), d ** -0.5, dtype, device)
    return p


def _capacity(num_tokens: int, m) -> int:
    cap = int(np.ceil(num_tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, int(np.ceil(cap / 8)) * 8)  # pad for lane alignment


def _activate(h, gate, activation):
    if activation == "swiglu":
        return F.silu(gate) * h
    if activation == "squared_relu":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")      # jax.nn.gelu's default


def _expert_ffn(params, xb, activation):
    """xb: (E, C, d) -> (E, C, d), every expert on its capacity rows."""
    h = torch.einsum("ecd,edf->ecf", xb, params["wu"].to(COMPUTE_DTYPE))
    gate = None
    if activation == "swiglu":
        gate = torch.einsum("ecd,edf->ecf", xb,
                            params["wg"].to(COMPUTE_DTYPE))
    h = _activate(h, gate, activation)
    return torch.einsum("ecf,efd->ecd", h, params["wd"].to(COMPUTE_DTYPE))


def _route(params, xn, k):
    """xn: (T,d) normed rows -> (fp32 router logits (T,E) from the bf16
    product, softmax gate weights (T,k), expert ids (T,k)).  A stable
    descending sort keeps equal logits in index order, the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none."""
    logits = torch.einsum("td,de->te", xn, params["wr"].to(COMPUTE_DTYPE))
    logits = logits.float()
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return logits, torch.softmax(top[:, :k], dim=-1), idx[:, :k]


def moe(params, x, cfg):
    """x: (B,S,D) -> (out, aux), aux = {"moe_aux_loss": 0-d fp32 tensor,
    "expert_load": (E,) fp32 count of the top-k choices per expert}.

    Capacity counts every row of the call, padding and inactive slots
    included, as the reference does.  Top-k takes the lower expert index
    first among equal router logits, as ``jax.lax.top_k`` does."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xn = rmsnorm(params["norm"], x, cfg.norm_eps).reshape(t, d)
    logits, gate_w, gate_idx = _route(params, xn, k)

    # ---- load-balance aux loss (Switch-style) + expert load metric
    # (counted with index_add_: bincount would wait for the device to size
    # its output)
    probs = torch.softmax(logits, dim=-1)                        # (T,E)
    me = torch.mean(probs, dim=0)
    ones = torch.ones(t * k, dtype=torch.float32, device=x.device)
    zeros = torch.zeros(e, dtype=torch.float32, device=x.device)
    ce = zeros.index_add(0, gate_idx[:, 0], ones[:t]) / t
    aux_loss = e * torch.sum(me * ce)
    expert_load = zeros.index_add(0, gate_idx.reshape(-1), ones)

    # ---- sort-based dispatch in one group
    cap = _capacity(t, m)
    rows = t * k
    flat_expert = gate_idx.reshape(rows)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_tok = order // k
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.arange(rows, device=x.device) - first
    valid = rank < cap
    # dropped rows go to the spare trash row e * cap, sliced off below
    slot = torch.where(valid, sorted_expert * cap + rank, e * cap)

    x_sorted = xn.to(COMPUTE_DTYPE)[sorted_tok]
    xb = torch.zeros((e * cap + 1, d), dtype=COMPUTE_DTYPE, device=x.device)
    xb[slot] = torch.where(valid[:, None], x_sorted, 0.0)
    yb = _expert_ffn(params, xb[:e * cap].reshape(e, cap, d), cfg.activation)
    yb = yb.reshape(e * cap, d)
    y_sorted = torch.where(valid[:, None], yb[slot.clamp(max=e * cap - 1)],
                           0.0)
    # unsort and weighted-combine the k expert outputs per token
    inv = torch.empty_like(order)
    inv[order] = torch.arange(rows, device=x.device)
    y_flat = y_sorted[inv]
    w_flat = gate_w.reshape(rows, 1).to(COMPUTE_DTYPE)
    y = torch.sum((y_flat * w_flat).reshape(t, k, d), dim=1)

    if m.dense_residual:
        h = torch.einsum("td,df->tf", xn, params["du"].to(COMPUTE_DTYPE))
        gate = None
        if cfg.activation == "swiglu":
            gate = torch.einsum("td,df->tf", xn,
                                params["dg"].to(COMPUTE_DTYPE))
        h = _activate(h, gate, cfg.activation)
        y = y + torch.einsum("tf,fd->td", h, params["dd"].to(COMPUTE_DTYPE))

    out = y.reshape(b, s, d)
    return out, {"moe_aux_loss": aux_loss, "expert_load": expert_load}
