"""A plain dense GQA decoder in fp32: the reference the served tokens are
judged by.

Written from the published description of the block (pre-norm RMSNorm,
grouped-query attention with half-split RoPE, a SwiGLU or squared-ReLU
MLP, a final RMSNorm and an unembedding), with the departures the
configuration's file lists under ``assumed``.  It imports nothing of the
program and takes no tensor the program made: the weights are the
benchmark's own, upcast to fp32 one layer at a time, and the tokens are
what the program served.  TF32 is switched off, so every product is fp32.

``precision="fp8"`` is the control: every matrix product takes its
operands rounded to float8 e4m3 (weights by output channel, activations by
row), the step below the bf16 the configuration serves in."""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

FP8_MAX = 448.0
Q_ROWS = 512          # query rows an attention block holds
LOGIT_ROWS = 256      # logit rows computed at a time


def exact_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the max-abs over it mapped to the format's largest value), back in
    fp32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linear:
    """``x @ w`` for w (in, out), in fp32 or in the fp8 control."""

    def __init__(self, w: torch.Tensor, precision: str):
        w = w.float()
        self.low = precision == "fp8"
        self.w = fp8(w, 0) if self.low else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.low:
            x = fp8(x, -1)
        return x @ self.w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, positions, theta):
    """Half-split rotation of x (L, heads, hd) at ``positions`` (L,), angles
    in float64."""
    hd = x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = positions.double()[:, None] * inv[None]
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v):
    """Causal attention of q (L, H, hd) over k, v (L, K, hd), fp32."""
    n, h, hd = q.shape
    kh = k.shape[1]
    g = h // kh
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                       # (K, hd, L)
    vv = v.permute(1, 0, 2)                       # (K, L, hd)
    pos = torch.arange(n, device=q.device)
    for lo in range(0, n, Q_ROWS):
        hi = min(n, lo + Q_ROWS)
        qb = q[lo:hi].reshape(hi - lo, kh, g, hd).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kt[:, None]) / math.sqrt(hd)   # (K, g, rows, L)
        s = s.masked_fill(pos[None, None, None, :] > pos[lo:hi, None], -math.inf)
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vv[:, None])                   # (K, g, rows, hd)
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, h, hd)
    return out


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
    eps = m["rms_norm_eps"]
    theta = m["rope_theta"]
    h, kh, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    xs: List[torch.Tensor] = []
    for s in seqs:
        ids = torch.as_tensor(list(s), dtype=torch.long, device=dev)
        xs.append(weights["embed"][ids].float())
    for lp in weights["layers"]:
        a, f = lp["attn"], lp["mlp"]
        wq = Linear(a["wq"].reshape(a["wq"].shape[0], -1), precision)
        wk = Linear(a["wk"].reshape(a["wk"].shape[0], -1), precision)
        wv = Linear(a["wv"].reshape(a["wv"].shape[0], -1), precision)
        wo = Linear(a["wo"].reshape(-1, a["wo"].shape[-1]), precision)
        wu = Linear(f["wu"], precision)
        wd = Linear(f["wd"], precision)
        wg = Linear(f["wg"], precision) if "wg" in f else None
        for i, x in enumerate(xs):
            n = x.shape[0]
            pos = torch.arange(n, device=dev)
            xn = rmsnorm(x, a["norm"]["scale"], eps)
            q = rope(wq(xn).view(n, h, hd), pos, theta)
            k = rope(wk(xn).view(n, kh, hd), pos, theta)
            v = wv(xn).view(n, kh, hd)
            x = x + wo(attend(q, k, v).reshape(n, h * hd))
            xn = rmsnorm(x, f["norm"]["scale"], eps)
            if wg is not None:
                act = torch.nn.functional.silu(wg(xn)) * wu(xn)
            else:
                act = torch.relu(wu(xn)).square()
            xs[i] = x + wd(act)
        del wq, wk, wv, wo, wu, wd, wg
    un = Linear(weights["unembed"], precision)
    for i, x in enumerate(xs):
        rows = wanted[i]
        for lo in range(rows.start, rows.stop, LOGIT_ROWS):
            hi = min(rows.stop, lo + LOGIT_ROWS)
            xn = rmsnorm(x[lo:hi], weights["final_norm"]["scale"], eps)
            visit(i, lo, un(xn))
