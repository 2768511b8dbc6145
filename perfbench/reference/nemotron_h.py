"""A plain Nemotron-H hybrid in fp32: the reference the served tokens of a
Nemotron-H cell are judged by.

Written from the published description (NVIDIA's Nemotron-H config and
the Mamba-2 paper, arXiv:2405.21060): each layer is RMSNorm, one sub-block
set by ``hybrid_override_pattern`` and the residual add, then a final
RMSNorm and an untied unembedding.

* ``M``, a Mamba-2 mixer: one input projection to z, x, B, C (``n_groups``
  of each) and dt; a causal depthwise conv of ``conv_kernel`` taps with
  bias over x, B and C, then SiLU; dt = softplus(dt + dt_bias); A =
  -exp(A_log); the **sequential** recurrence, per head h of group g,
  h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t x_tᵀ and y_t = C_t·h_t + D·x_t;
  then y·silu(z) normalised over each group's channels apart (the gate
  before the norm), and the output projection.
* ``-``, an MLP: relu(x W_up)² W_down.
* ``*``, grouped-query attention, causal, with no positional encoding.

Departures from the published model, which the configuration's file lists
under ``assumed``: attention has no rotary embedding (the config names
none); weights are random, with fixed ``A_log``, ``D`` and ``dt_bias``.

It imports nothing of the program and takes no tensor the program made:
the weights are the benchmark's own, upcast to fp32 a layer at a time, and
the tokens are what the program served.  TF32 is off.  The recurrence runs
the sequences side by side, token by token, right-padded with dt = 0 (a
step that changes no state).  ``precision="fp8"`` is the control: the
projections take their operands rounded to float8 e4m3, as in
``dense_gqa``."""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

from reference.dense_gqa import LOGIT_ROWS, Linear, attend, exact_fp32, \
    rmsnorm


def causal_conv(x, w, b):
    """x (L, C), w (K, C) with w[K-1] on the current position, b (C,): the
    sum over the K taps, zeros before the first position."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    n = x.shape[0]
    y = b.float().expand_as(x).clone()
    for i in range(k):
        y = y + xp[i:i + n] * w[i].float()
    return y


def recurrence(x, dt, a, b, c, d):
    """The Mamba-2 scan, one token at a time, over sequences side by side.
    x (S, L, H, P), dt (S, L, H), a (H,) = -exp(A_log), b and c (S, L, G,
    N), d (H,) -> y (S, L, H, P)."""
    s, n_tok, h, p = x.shape
    g, n = b.shape[2:]
    state = x.new_zeros((s, g, h // g, n, p))
    y = torch.empty_like(x)
    decay = torch.exp(dt * a)                               # (S, L, H)
    dx = (dt[..., None] * x).view(s, n_tok, g, h // g, p)
    for t in range(n_tok):
        state.mul_(decay[:, t].view(s, g, h // g, 1, 1))
        state.addcmul_(b[:, t, :, None, :, None], dx[:, t, :, :, None, :])
        out = torch.matmul(c[:, t, :, None, None, :], state)  # (S,G,H/G,1,P)
        y[:, t] = out.reshape(s, h, p)
    return y + d[:, None] * x


def gated_norm(y, z, scale, groups, eps):
    """y·silu(z), then RMSNorm over each of ``groups`` slices of the
    channels, times ``scale``."""
    v = y * F.silu(z)
    v = v.view(*v.shape[:-1], groups, -1)
    v = v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps)
    return v.reshape(y.shape) * scale.float()


def mamba(p, xs: List[torch.Tensor], m: dict, precision: str):
    """One Mamba-2 layer over every sequence of ``xs``; returns the
    sub-block's outputs (before the residual add)."""
    eps = m["layer_norm_epsilon"]
    h, hp = m["mamba_num_heads"], m["mamba_head_dim"]
    g, n = m["n_groups"], m["ssm_state_size"]
    di = h * hp
    w_in, w_out = Linear(p["w_in"], precision), Linear(p["w_out"], precision)
    a = -torch.exp(p["A_log"].float())
    lens = [x.shape[0] for x in xs]
    top = max(lens)
    parts = []
    for x in xs:
        z, xbc, dt = torch.split(w_in(rmsnorm(x, p["norm"]["scale"], eps)),
                                 [di, di + 2 * g * n, h], dim=-1)
        xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
        dt = F.softplus(dt + p["dt_bias"].float())
        parts.append((z, xbc, dt))

    def stack(tensors, shape):
        return torch.stack([F.pad(t, (0, 0, 0, top - t.shape[0])).view(
            top, *shape) for t in tensors])
    xbc = [q[1] for q in parts]
    x = stack([t[:, :di] for t in xbc], (h, hp))
    b = stack([t[:, di:di + g * n] for t in xbc], (g, n))
    c = stack([t[:, di + g * n:] for t in xbc], (g, n))
    dt = stack([q[2] for q in parts], (h,))        # 0 past each length
    y = recurrence(x, dt, a, b, c, p["D"].float())
    out = []
    for i, (z, _, _) in enumerate(parts):
        yi = y[i, :lens[i]].reshape(lens[i], di)
        out.append(w_out(gated_norm(yi, z, p["out_norm"]["scale"], g, eps)))
    return out


def attention(p, x, m: dict, precision: str):
    eps = m["layer_norm_epsilon"]
    h, kh, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["attention_head_dim"])
    n = x.shape[0]
    xn = rmsnorm(x, p["norm"]["scale"], eps)
    q, k, v = (Linear(p[w].reshape(p[w].shape[0], -1), precision)(xn)
               for w in ("wq", "wk", "wv"))
    o = attend(q.view(n, h, hd), k.view(n, kh, hd), v.view(n, kh, hd))
    return Linear(p["wo"].reshape(-1, p["wo"].shape[-1]), precision)(
        o.reshape(n, h * hd))


def mlp(p, x, m: dict, precision: str):
    xn = rmsnorm(x, p["norm"]["scale"], m["layer_norm_epsilon"])
    up = Linear(p["wu"], precision)(xn)
    return Linear(p["wd"], precision)(torch.relu(up).square())


def logits_at(weights, m: dict, seqs: Sequence[Sequence[int]],
              wanted: Sequence[range], visit: Callable[[int, int, torch.Tensor],
                                                       None],
              precision: str = "fp32") -> None:
    """Run every sequence of ``seqs`` through the model ``m`` (a
    configuration file's ``model``) and call ``visit(i, p, logits)`` with
    the fp32 logits (rows, V) of sequence i at positions ``p..p+rows-1``,
    for the positions in ``wanted[i]``."""
    exact_fp32()
    dev = weights["embed"].device
    xs: List[torch.Tensor] = []
    for s in seqs:
        ids = torch.as_tensor(list(s), dtype=torch.long, device=dev)
        xs.append(weights["embed"][ids].float())
    for kind, lp in zip(m["hybrid_override_pattern"], weights["layers"]):
        if kind == "M":
            outs = mamba(lp["mamba"], xs, m, precision)
        elif kind == "*":
            outs = [attention(lp["attn"], x, m, precision) for x in xs]
        else:
            outs = [mlp(lp["mlp"], x, m, precision) for x in xs]
        xs = [x + o for x, o in zip(xs, outs)]
        del outs
    un = Linear(weights["unembed"], precision)
    eps = m["layer_norm_epsilon"]
    for i, x in enumerate(xs):
        rows = wanted[i]
        for lo in range(rows.start, rows.stop, LOGIT_ROWS):
            hi = min(rows.stop, lo + LOGIT_ROWS)
            xn = rmsnorm(x[lo:hi], weights["final_norm"]["scale"], eps)
            visit(i, lo, un(xn))
