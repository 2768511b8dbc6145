"""Token-choice top-k Mixture-of-Experts on torch: port of
``src/repro/models/moe.py``.

Each token goes to its top-k experts (plus Arctic's optional dense
residual).  Dispatch is sort-based at a fixed capacity: each token is
replicated k times, the (token, expert) rows are stably sorted by expert
id, row r of expert e lands in slot ``e * capacity + r``, and rows past
capacity are dropped.  The batched expert products run on the (E, capacity,
d) buffer, and the rows are scattered back, unsorted and weighted.

As in the reference, the dispatch takes one group per data shard when a
sharding policy is installed (``_dispatch_groups``, moe.py:49-60): each
group's rows fill their own capacity slots, so the group count changes
capacity and which rows are dropped.  With no policy there is one group.
The reference's ``shard(...)`` sites are kept (moe.py:68, 125, 132, 162).

Parameters are plain dicts of tensors with the reference's names and
layouts; functions take an explicit ``torch.Generator`` and device, as
``layers.py`` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import COMPUTE_DTYPE, _init, rmsnorm, rmsnorm_init
from repro_torch.sharding import current_policy, shard
from repro_torch.sharding.policy import mesh_sizes


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
    """xb: (E, R, d) -> (E, R, d), every expert on its R buffer rows (the
    capacity rows of each dispatch group, group after group)."""
    h = torch.einsum("ecd,edf->ecf", xb, params["wu"].to(COMPUTE_DTYPE))
    h = shard(h, "experts", "batch", "expert_mlp")
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


def _dispatch_groups(num_tokens: int) -> int:
    """Number of data-local dispatch groups: the policy mesh's data-axis
    size, halved until it divides ``num_tokens`` (1 with no policy)
    (moe.py:49-60)."""
    policy = current_policy()
    if policy is None:
        return 1
    sizes = mesh_sizes(policy.mesh)
    g = sizes.get("data", 1) * sizes.get("pod", 1)
    while g > 1 and num_tokens % g:
        g //= 2
    return max(g, 1)


def _dispatch(xg, gate_idx, e, cap):
    """xg: (tg, d) rows in the compute dtype; gate_idx: (tg, k).  Each row
    replicated k times, stably sorted by expert id; row r of expert e lands
    in slot ``e * cap + r``; rows past capacity are dropped.  Returns the
    (E, cap, d) expert buffer and what :func:`_combine` needs to bring its
    rows back: (buffer, (order, slot, valid))."""
    tg, d = xg.shape
    k = gate_idx.shape[1]
    rows = tg * k
    flat_expert = gate_idx.reshape(rows)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_tok = order // k
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.arange(rows, device=xg.device) - first
    valid = rank < cap
    # dropped rows go to the spare trash row e * cap, sliced off below
    slot = torch.where(valid, sorted_expert * cap + rank, e * cap)
    x_sorted = xg[sorted_tok]
    xb = torch.zeros((e * cap + 1, d), dtype=xg.dtype, device=xg.device)
    xb[slot] = torch.where(valid[:, None], x_sorted, 0.0)
    return xb[:e * cap].reshape(e, cap, d), (order, slot, valid)


def _combine(yb, rows_of, gate_w):
    """yb: (E, cap, d) expert outputs of one group -> (tg, d): each row
    back in token order, the k outputs of a token weighted and summed."""
    order, slot, valid = rows_of
    e, cap, d = yb.shape
    tg, k = gate_w.shape
    rows = tg * k
    yb = yb.reshape(e * cap, d)
    y_sorted = torch.where(valid[:, None], yb[slot.clamp(max=e * cap - 1)],
                           0.0)
    # unsort and weighted-combine the k expert outputs per token
    inv = torch.empty_like(order)
    inv[order] = torch.arange(rows, device=yb.device)
    y_flat = y_sorted[inv]
    w_flat = gate_w.reshape(rows, 1).to(COMPUTE_DTYPE)
    return torch.sum((y_flat * w_flat).reshape(tg, k, d), dim=1)


def _split_by(like):
    """Placements that are partial sums over the mesh axes that split
    ``like``'s groups, replicated over the rest."""
    return [Partial() if isinstance(p, Shard) else Replicate()
            for p in like.placements]


def _sum_over_groups(local, like):
    """The sum of a statistic over every rank's groups, as a DTensor."""
    return DTensor.from_local(local, like.device_mesh, _split_by(like),
                              run_check=False)


def moe(params, x, cfg):
    """x: (B,S,D) -> (out, aux), aux = {"moe_aux_loss": 0-d fp32 tensor,
    "expert_load": (E,) fp32 count of the top-k choices per expert}.

    Tokens are dispatched in :func:`_dispatch_groups` groups of consecutive
    rows, each into its own capacity slots (moe.py:102-140); capacity counts
    every row of the group, padding and inactive slots included, as the
    reference does.  Top-k takes the lower expert index first among equal
    router logits, as ``jax.lax.top_k`` does.  Under a policy over a mesh,
    each data shard routes, dispatches and combines its own groups on local
    tensors, and only the expert products run on the sharded buffer."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xn = rmsnorm(params["norm"], x, cfg.norm_eps).reshape(t, d)
    groups = _dispatch_groups(t)
    tg = t // groups
    cap = _capacity(tg, m)
    xg = shard(xn.reshape(groups, tg, d), "batch", None, None)
    xl = xg.to_local() if isinstance(xg, DTensor) else xg    # own groups
    wr = params["wr"]
    if isinstance(wr, DTensor):
        # the router's (d, E) weight, gathered: each rank routes its own
        # rows over every expert, so its gradient sums over the data shards
        wr = wr.redistribute(wr.device_mesh, [Replicate()] * wr.ndim) \
            .to_local(grad_placements=_split_by(xg))
    logits, gate_w, gate_idx = _route({"wr": wr}, xl.reshape(-1, d), k)

    # ---- load-balance aux loss (Switch-style) + expert load metric
    # (counted with index_add_: bincount would wait for the device to size
    # its output)
    tl = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)                        # (T,E)
    ones = torch.ones(tl * k, dtype=torch.float32, device=x.device)
    zeros = torch.zeros(e, dtype=torch.float32, device=x.device)
    top1 = zeros.index_add(0, gate_idx[:, 0], ones[:tl])
    expert_load = zeros.index_add(0, gate_idx.reshape(-1), ones)
    if isinstance(xg, DTensor):
        # means over every rank's rows: sums over the data shards over t
        me = _sum_over_groups(torch.sum(probs, dim=0), xg) / t
        ce = _sum_over_groups(top1, xg) / t
        expert_load = _sum_over_groups(expert_load, xg)
    else:
        me = torch.mean(probs, dim=0)
        ce = top1 / tl
    aux_loss = e * torch.sum(me * ce)

    # ---- sort-based dispatch, one group of tg rows at a time, into an
    # expert-major buffer (E, G * cap, d), the groups' capacity rows one
    # after another.  The reference's (G, E, cap, d) buffer takes the sites
    # ("batch", "experts", None, None) and, for the products' hidden rows,
    # ("batch", "experts", "expert_batch", "expert_mlp") (moe.py:68, 132);
    # here the rows dim takes what its G takes, "batch", and E "experts",
    # the same placements.  (DTensor's backward of a product over a sharded
    # G dim fails to view its local shard, so the products see no G dim.)
    xc = xl.to(COMPUTE_DTYPE)
    disp = [_dispatch(xc[i], gate_idx[i * tg:(i + 1) * tg], e, cap)
            for i in range(xl.shape[0])]
    xb = torch.cat([buf for buf, _ in disp], dim=1)
    if isinstance(xg, DTensor):
        mesh = xg.device_mesh
        rows = [Shard(1) if isinstance(p, Shard) else Replicate()
                for p in xg.placements]
        xb = DTensor.from_local(xb, mesh, rows, run_check=False,
                                shape=(e, groups * cap, d),
                                stride=(groups * cap * d, d, 1))
    xb = shard(xb, "experts", "batch", None)
    yb = _expert_ffn(params, xb, cfg.activation)
    if isinstance(xg, DTensor):
        yb = yb.redistribute(mesh, rows).to_local()
    y = torch.stack([_combine(yb[:, i * cap:(i + 1) * cap], rows_of,
                              gate_w[i * tg:(i + 1) * tg])
                     for i, (_, rows_of) in enumerate(disp)])
    if isinstance(xg, DTensor):
        y = DTensor.from_local(y, mesh, xg.placements, run_check=False,
                               shape=xg.shape, stride=xg.stride())
    y = y.reshape(t, d)

    if m.dense_residual:
        h = torch.einsum("td,df->tf", xn, params["du"].to(COMPUTE_DTYPE))
        gate = None
        if cfg.activation == "swiglu":
            gate = torch.einsum("td,df->tf", xn,
                                params["dg"].to(COMPUTE_DTYPE))
        h = _activate(h, gate, cfg.activation)
        y = y + torch.einsum("tf,fd->td", h, params["dd"].to(COMPUTE_DTYPE))

    out = y.reshape(b, s, d)
    return (shard(out, "batch", "seq", "act_embed"),
            {"moe_aux_loss": aux_loss, "expert_load": expert_load})
