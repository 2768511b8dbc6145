"""Sub-quadratic sequence mixers on torch: port of ``src/repro/models/ssm.py``
(Mamba-2-style SSD, and the xLSTM's mLSTM and sLSTM blocks).

The Mamba block uses the Mamba-2 SSD chunked form: within a chunk a masked
per-head decay matmul, across chunks a small state recurrence.  The mLSTM
uses the analogous chunked linear-attention form with log-space gate
stabilisation, and the sLSTM keeps its sequential recurrence over time.
Where the reference scans (``lax.scan`` over chunks or time), the port runs
a Python loop; the reference's scan-unroll flag has no counterpart.  Its
``shard(...)`` sites are kept (ssm.py:145, 167, 329, 409): under a policy
over a mesh the blocks compute on DTensors (``repro_torch.sharding``).

Dtypes are the reference's: the SSM, mLSTM and sLSTM states, ``dt`` and the
gates are fp32; the conv state and the projections run in
``COMPUTE_DTYPE`` (bf16) wherever the reference casts to it.  Parameters
are plain dicts of tensors with the reference's names and layouts; init
draws from an explicit ``torch.Generator`` on the caller's device, one leaf
at a time, as ``layers.py`` does.  No function here is a Pallas kernel in
the reference, so none has a CUDA kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import (COMPUTE_DTYPE, _init, head_einsum,
                                       merge_heads, on_local_shards,
                                       rmsnorm, rmsnorm_init)
from repro_torch.sharding import shard
from repro_torch.sharding.policy import mesh_sizes


def _softplus(x):
    """``jax.nn.softplus``: exactly ``logaddexp(x, 0)``.  ``F.softplus``
    returns ``x`` itself above 20, which is off by up to 2e-9 there."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu(x):
    """``jax.nn.silu`` as the reference computes it in bf16:
    ``x * (1 / (1 + exp(-x)))``, each step rounded to x's dtype (bit-equal
    on the CPU).  ``F.silu`` rounds once, which moves about a third of the
    bf16 outputs by an ulp."""
    return x * (1 / (1 + torch.exp(-x)))


def _pad_seq(x, pad, value=0.0):
    """Right-pad axis 1 of ``x`` by ``pad`` entries of ``value``."""
    widths = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, widths, value=value)


# =================================================================== Mamba ==

def mamba_init(generator, cfg, dtype, device):
    """The reference's leaves and scales (ssm.py:25-44); ``A_log``, ``D``,
    ``dt_bias`` and the norms are deterministic."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    n = s.d_state
    conv_dim = di + 2 * n
    # the reference's linspace and log run in fp32 before the cast
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                     device=device))
    return {
        "norm": rmsnorm_init(d, dtype, device),
        "w_in": _init(generator, (d, 2 * di + 2 * n + nh), d ** -0.5, dtype,
                      device),
        "conv_w": _init(generator, (s.d_conv, conv_dim), 0.3, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        # A in [1, 16]: stable decays
        "A_log": a_log.to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.full((nh,), -4.0, dtype=dtype, device=device),
        "out_norm": rmsnorm_init(di, dtype, device),
        "w_out": _init(generator, (di, d), di ** -0.5, dtype, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). state: (B,K-1,C) or None.
    Returns (y, new_state) where new_state holds the last K-1 inputs.  The
    taps are summed in order in x's dtype, as the reference's ``sum`` does."""
    k = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)        # promotes as jnp.concatenate
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b, new_state


def ssd_chunked(x, dt, a_log, b_in, c_in, chunk):
    """Chunked SSD scan.

    x: (B,S,H,P) inputs per head; dt: (B,S,H) step sizes (>0);
    a_log: (H,) log of positive decay rates A (decay = exp(-dt·A));
    b_in/c_in: (B,S,N) shared input/output projections (n_groups=1).
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,N,P) fp32).
    """
    bsz, s0, h, p = x.shape
    n = b_in.shape[-1]
    L = min(chunk, s0)
    pad = (-s0) % L
    if pad:
        # dt=0 padding is exact: decay=exp(0)=1 and contribution dt·B·x = 0,
        # so the final state is unaffected by padded steps.
        x, dt, b_in, c_in = (_pad_seq(t, pad) for t in (x, dt, b_in, c_in))
    s = s0 + pad
    nc = s // L
    neg_a = -torch.exp(a_log.float())                            # (H,) < 0
    da = dt.float() * neg_a                                      # (B,S,H) <= 0
    lcum = torch.cumsum(da.reshape(bsz, nc, L, h), dim=2)        # (B,nc,L,H)
    xc = x.reshape(bsz, nc, L, h, p).float()
    dtc = dt.reshape(bsz, nc, L, h).float()
    bc = b_in.reshape(bsz, nc, L, n).float()
    cc = c_in.reshape(bsz, nc, L, n).float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xk, dtk, lk, bk, ck = xc[:, c], dtc[:, c], lcum[:, c], bc[:, c], cc[:, c]
        # intra-chunk: masked per-head decay attention
        g = torch.einsum("bin,bjn->bij", ck, bk)                 # (B,L,L)
        # exp(l_i - l_j) for j <= i, else 0: the reference multiplies by
        # the mask after the exp, whose j > i entries can overflow to inf
        # (and inf * 0 to NaN) on long chunks; masking first is the same
        # wherever the reference's value is finite
        decay = torch.exp((lk[:, :, None, :] - lk[:, None, :, :])
                          .masked_fill(~tri[None, :, :, None], -math.inf))
        m = g[..., None] * decay                                 # (B,L,L,H)
        # sum_j m[b,i,j,h] dt[b,j,h] x[b,j,h,p], a batched matmul over (b,h)
        mw = (m * dtk[:, None, :, :]).permute(0, 3, 1, 2)        # (B,H,L,L)
        y_intra = torch.matmul(mw, xk.permute(0, 2, 1, 3))        # (B,H,L,P)
        y_intra = y_intra.permute(0, 2, 1, 3)                     # (B,L,H,P)
        # inter-chunk: incoming state decayed to each position
        y_inter = torch.einsum("bin,bhnp->bihp", ck, state)
        y_inter = y_inter * torch.exp(lk)[..., None]
        # state update to chunk end
        total = lk[:, -1, :]                                     # (B,H)
        w = torch.exp(total[:, None, :] - lk) * dtk              # (B,L,H)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bjn,bjhp->bhnp", bk, w[..., None] * xk)
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y[:, :s0], state


def _ssd_step(x, dt, a_log, b_in, c_in, state):
    """The single-token recurrent step (S == 1): x (B,H,P), dt (B,H),
    b_in/c_in (B,N), state (B,H,N,P) fp32 -> (y (B,H,P), new state)."""
    a = torch.exp(-torch.exp(a_log.float()) * dt)                 # (B,H)
    upd = torch.einsum("bn,bhp->bhnp", b_in.float(),
                       dt[:, :, None] * x.float())
    state = state * a[..., None, None] + upd
    return torch.einsum("bn,bhnp->bhp", c_in.float(), state), state


def mamba_block(params, x, cfg, *, cache=None):
    """Mamba-2 SSD block. x: (B,S,D). cache: dict(ssm=(B,H,N,P), conv=(B,K-1,C))
    for single-token decode. Returns (out, new_cache)."""
    s_cfg = cfg.ssm
    bsz, s, d = x.shape
    di = s_cfg.expand * d
    nh = di // s_cfg.head_dim
    p = s_cfg.head_dim
    n = s_cfg.d_state

    xn = rmsnorm(params["norm"], x, cfg.norm_eps)
    proj = torch.einsum("bsd,dk->bsk", xn, params["w_in"].to(COMPUTE_DTYPE))
    z, xr, b_in, c_in, dt = torch.split(proj, [di, di, n, n, nh], dim=-1)

    xbc = torch.cat([xr, b_in, c_in], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(
        xbc, params["conv_w"].to(COMPUTE_DTYPE),
        params["conv_b"].to(COMPUTE_DTYPE), conv_state)
    xbc = _silu(xbc)
    xr, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)

    dt = _softplus(dt.float() + params["dt_bias"].float())      # (B,S,H)
    x_heads = shard(xr.reshape(bsz, s, nh, p), "batch", "seq", "ssm_inner",
                    None)

    # the scan is independent per batch row and head: under a policy it
    # runs on each rank's local shards
    if cache is not None:
        y, state = on_local_shards(
            _ssd_step, [(x_heads[:, 0], 0, 1), (dt[:, 0], 0, 1),
                        (params["A_log"], None, 0), (b_in[:, 0], 0, None),
                        (c_in[:, 0], 0, None), (cache["ssm"], 0, 1)],
            ((0, 1), (0, 1)), heads=nh)
        y = y[:, None]                                            # (B,1,H,P)
    else:
        y, state = on_local_shards(
            lambda *a: ssd_chunked(*a, s_cfg.chunk),
            [(x_heads, 0, 2), (dt, 0, 2), (params["A_log"], None, 0),
             (b_in, 0, None), (c_in, 0, None)], ((0, 2), (0, 1)), heads=nh)
    new_cache = {"ssm": state, "conv": new_conv}

    y = y.to(COMPUTE_DTYPE) + params["D"].to(COMPUTE_DTYPE)[:, None] * x_heads
    y = y.reshape(bsz, s, di)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps) * _silu(z)
    out = torch.einsum("bsk,kd->bsd", y, params["w_out"].to(COMPUTE_DTYPE))
    return shard(out, "batch", "seq", "act_embed"), new_cache


def mamba_cache_init(cfg, batch, device):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return {
        "ssm": torch.zeros((batch, nh, s.d_state, s.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state),
                            dtype=COMPUTE_DTYPE, device=device),
    }


# =================================================================== mLSTM ==

def mlstm_init(generator, cfg, dtype, device):
    """The reference's leaves and scales (ssm.py:183-201)."""
    xc = cfg.xlstm
    d = cfg.d_model
    di = xc.proj_factor * d
    h = cfg.num_heads
    hd = di // h
    return {
        "norm": rmsnorm_init(d, dtype, device),
        "w_up": _init(generator, (d, 2 * di), d ** -0.5, dtype, device),
        "wq": _init(generator, (di, h, hd), di ** -0.5, dtype, device),
        "wk": _init(generator, (di, h, hd), di ** -0.5, dtype, device),
        "wv": _init(generator, (di, h, hd), di ** -0.5, dtype, device),
        "w_i": _init(generator, (d, h), d ** -0.5, dtype, device),
        "w_f": _init(generator, (d, h), d ** -0.5, dtype, device),
        "b_f": torch.full((h,), 3.0, dtype=dtype, device=device),  # open
        "head_norm": rmsnorm_init(hd, dtype, device),
        "w_down": _init(generator, (di, d), di ** -0.5, dtype, device),
    }


def mlstm_chunked(q, k, v, log_i, log_f, chunk, state=None):
    """Chunked, stabilized mLSTM linear attention.

    q,k,v: (B,S,H,P); log_i: (B,S,H) exponential input gate (pre-exp);
    log_f: (B,S,H) log forget gate (<= 0, from logsigmoid).
    state: (C: (B,H,P,P), n: (B,H,P), m: (B,H)) or None.
    Returns (h: (B,S,H,P) in q's dtype, new_state, fp32).
    """
    bsz, s0, h, p = q.shape
    L = min(chunk, s0)
    pad = (-s0) % L
    if pad:
        # log_i = -1e30 (no contribution), log_f = 0 (no decay) is exact:
        # padded steps leave (C, n, m) unchanged.
        q, k, v, log_f = (_pad_seq(t, pad) for t in (q, k, v, log_f))
        log_i = _pad_seq(log_i, pad, value=-1e30)
    s = s0 + pad
    nc = s // L
    qf = q.float() * (p ** -0.5)
    li = log_i.float().reshape(bsz, nc, L, h)
    fcum = torch.cumsum(log_f.float().reshape(bsz, nc, L, h), dim=2)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    qc = qf.reshape(bsz, nc, L, h, p)
    kc = k.float().reshape(bsz, nc, L, h, p)
    vc = v.float().reshape(bsz, nc, L, h, p)

    if state is None:
        c_st = torch.zeros((bsz, h, p, p), dtype=torch.float32,
                           device=q.device)
        n_st = torch.zeros((bsz, h, p), dtype=torch.float32, device=q.device)
        m_st = torch.full((bsz, h), -math.inf, dtype=torch.float32,
                          device=q.device)
    else:
        c_st, n_st, m_st = state

    hs = []
    for c in range(nc):
        qk, kk, vk, lik, fck = qc[:, c], kc[:, c], vc[:, c], li[:, c], fcum[:, c]
        t = lik - fck                                   # (B,L,H)
        g = torch.maximum(m_st[:, None, :],
                          torch.cummax(t, dim=1).values)  # (B,L,H)
        m_i = fck + g
        # intra weights: exp(t_j - g_i) masked j<=i (masked before the exp,
        # as in ssd_chunked)
        w_intra = torch.exp((t[:, None, :, :] - g[:, :, None, :])
                            .masked_fill(~tri[None, :, :, None], -math.inf))
        sqk = torch.einsum("bihp,bjhp->bijh", qk, kk)   # (B,L,L,H)
        sw = (sqk * w_intra).permute(0, 3, 1, 2)        # (B,H,L,L)
        num = torch.matmul(sw, vk.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        den = sw.sum(dim=-1).permute(0, 2, 1)           # (B,L,H)
        # inter contribution (state scaled by exp(m_st - g_i))
        w_state = torch.exp(m_st[:, None, :] - g)       # (B,L,H)
        num = num + torch.einsum("bihp,bhpq->bihq", qk, c_st) \
            * w_state[..., None]
        den = den + torch.einsum("bihp,bhp->bih", qk, n_st) * w_state
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_i))[..., None])
        # state update to chunk end
        ftot = fck[:, -1, :]                            # (B,H)
        m_new = torch.maximum(m_st + ftot, ftot + torch.amax(t, dim=1))
        w_end = torch.exp(ftot[:, None, :] + t - m_new[:, None, :])  # (B,L,H)
        keep = torch.exp(m_st + ftot - m_new)
        c_st = c_st * keep[..., None, None] + torch.einsum(
            "bjhp,bjhq->bhpq", w_end[..., None] * kk, vk)
        n_st = n_st * keep[..., None] + torch.einsum(
            "bjh,bjhp->bhp", w_end, kk)
        m_st = m_new
    h_seq = torch.stack(hs, dim=1).reshape(bsz, s, h, p)
    return h_seq[:, :s0].to(q.dtype), (c_st, n_st, m_st)


def mlstm_step(q, k, v, log_i, log_f, state):
    """Exact single-token mLSTM recurrence. q,k,v: (B,H,P); gates: (B,H)."""
    c_st, n_st, m_st = state
    p = q.shape[-1]
    qf = q.float() * (p ** -0.5)
    kf = k.float()
    vf = v.float()
    li = log_i.float()
    lf = log_f.float()
    m_new = torch.maximum(lf + m_st, li)
    decay = torch.exp(lf + m_st - m_new)
    inp = torch.exp(li - m_new)
    c_st = c_st * decay[..., None, None] + inp[..., None, None] * torch.einsum(
        "bhp,bhq->bhpq", kf, vf)
    n_st = n_st * decay[..., None] + inp[..., None] * kf
    num = torch.einsum("bhp,bhpq->bhq", qf, c_st)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", qf, n_st)),
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (c_st, n_st, m_new)


def _mlstm_step_flat(q, k, v, log_i, f_pre, c_st, n_st, m_st):
    """:func:`mlstm_step` from the forget gate's pre-activation, with the
    state flat: (h, C, n, m)."""
    h, state = mlstm_step(q, k, v, log_i, F.logsigmoid(f_pre),
                          (c_st, n_st, m_st))
    return (h, *state)


def _mlstm_chunked_flat(q, k, v, log_i, f_pre, chunk):
    """:func:`mlstm_chunked` from the forget gate's pre-activation, with the
    state flat: (h_seq, C, n, m)."""
    h_seq, state = mlstm_chunked(q, k, v, log_i, F.logsigmoid(f_pre), chunk)
    return (h_seq, *state)


def mlstm_block(params, x, cfg, *, cache=None):
    """mLSTM block. x: (B,S,D). cache: dict(C, n, m) for single-token
    decode.  Returns (out, new_cache)."""
    xc = cfg.xlstm
    h = cfg.num_heads
    xn = rmsnorm(params["norm"], x, cfg.norm_eps)
    up = torch.einsum("bsd,dk->bsk", xn, params["w_up"].to(COMPUTE_DTYPE))
    inner, z = torch.chunk(up, 2, dim=-1)
    q, k, v = (head_einsum("bsk,khp->bshp", inner,
                           params[w].to(COMPUTE_DTYPE), w_heads=1,
                           out_heads=2)
               for w in ("wq", "wk", "wv"))
    log_i = torch.einsum("bsd,dh->bsh", xn, params["w_i"].to(COMPUTE_DTYPE))
    f_pre = (torch.einsum("bsd,dh->bsh", xn,
                          params["w_f"].to(COMPUTE_DTYPE)).float()
             + params["b_f"].float())

    # the forget gate's log-sigmoid and the scan are independent per batch
    # row and head: under a policy they run on each rank's local shards
    if cache is not None:
        h_out, *new_state = on_local_shards(
            _mlstm_step_flat,
            [(q[:, 0], 0, 1), (k[:, 0], 0, 1), (v[:, 0], 0, 1),
             (log_i[:, 0], 0, 1), (f_pre[:, 0], 0, 1), (cache["C"], 0, 1),
             (cache["n"], 0, 1), (cache["m"], 0, 1)],
            ((0, 1),) * 4, heads=h)
        h_seq = h_out[:, None]
    else:
        h_seq, *new_state = on_local_shards(
            lambda *a: _mlstm_chunked_flat(*a, xc.chunk),
            [(t, 0, 2) for t in (q, k, v, log_i, f_pre)],
            ((0, 2),) + ((0, 1),) * 3, heads=h)
    new_cache = {"C": new_state[0], "n": new_state[1], "m": new_state[2]}
    h_seq = rmsnorm(params["head_norm"], h_seq, cfg.norm_eps)
    h_flat = merge_heads(h_seq) * _silu(z)
    out = torch.einsum("bsk,kd->bsd", h_flat,
                       params["w_down"].to(COMPUTE_DTYPE))
    return shard(out, "batch", "seq", "act_embed"), new_cache


def mlstm_cache_init(cfg, batch, device):
    h = cfg.num_heads
    hd = cfg.xlstm.proj_factor * cfg.d_model // h
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -math.inf, dtype=torch.float32,
                        device=device),
    }


# =================================================================== sLSTM ==

GATES = ("z", "i", "f", "o")


def slstm_init(generator, cfg, dtype, device):
    """The reference's leaves and scales (ssm.py:344-356)."""
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    p = {"norm": rmsnorm_init(d, dtype, device),
         "head_norm": rmsnorm_init(hd, dtype, device),
         "w_out": _init(generator, (d, d), d ** -0.5, dtype, device)}
    for g in GATES:
        p[f"w_{g}"] = _init(generator, (d, d), d ** -0.5, dtype, device)
        p[f"r_{g}"] = _init(generator, (h, hd, hd), hd ** -0.5, dtype, device)
        p[f"b_{g}"] = (torch.full((d,), 1.0, dtype=dtype, device=device)
                       if g == "f" else
                       torch.zeros((d,), dtype=dtype, device=device))
    return p


def _recurrent_weights(*r_gates):
    """The four ``r_g`` (h, hd, hd) as one fp32 (h, hd, 4 * hd), gate-major
    along the last axis: one batched product a step gives every gate's
    recurrent term.  The reference casts each ``r_g`` to fp32 inside every
    step (ssm.py:369-370); casting once is the same values."""
    heads, hd, _ = r_gates[0].shape
    r = torch.stack([t.float() for t in r_gates], dim=2)
    return r.reshape(heads, hd, 4 * hd)


def _slstm_step(r, carry, x_t):
    """One sLSTM step.  carry: (c, n, h, m) each (B, H, hd) fp32; x_t: (B, H,
    4, hd) fp32, the input contributions [z, i, f, o] per head; r: from
    :func:`_recurrent_weights`.  Returns (new carry, h_new)."""
    c, n, hh, m = carry
    bsz, heads, hd = hh.shape
    rec = torch.bmm(hh.transpose(0, 1), r).transpose(0, 1)   # (B, H, 4*hd)
    pre = x_t + rec.reshape(bsz, heads, 4, hd)
    z = torch.tanh(pre[:, :, 0])
    log_i = pre[:, :, 1]
    log_f = F.logsigmoid(pre[:, :, 2])
    o = torch.sigmoid(pre[:, :, 3])
    m_new = torch.maximum(log_f + m, log_i)
    keep = torch.exp(log_f + m - m_new)
    inp = torch.exp(log_i - m_new)
    c = keep * c + inp * z
    n = keep * n + inp
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new), h_new


def _slstm_scan(rz, ri, rf, ro, xg, *carry):
    """The sLSTM's steps over xg (S, B, H, 4, hd) from ``carry`` (each (B,
    H * hd)), with the gates' recurrent weights ``r_*`` (h, hd, hd) ->
    (h_seq (B, S, H, hd), c, n, h, m each (B, H, hd))."""
    r = _recurrent_weights(rz, ri, rf, ro)
    carry = tuple(t.reshape(t.shape[0], -1, rz.shape[-1]) for t in carry)
    hs = []
    for x_t in xg:
        carry, h_t = _slstm_step(r, carry, x_t)
        hs.append(h_t)
    return (torch.stack(hs, dim=1), *carry)


def slstm_block(params, x, cfg, *, cache=None):
    """sLSTM block. x: (B,S,D). cache: dict(c, n, h, m), each (B, D) fp32,
    for single-token decode.  Returns (out, new_cache)."""
    bsz, s, d = x.shape
    heads = cfg.num_heads
    hd = d // heads
    xn = rmsnorm(params["norm"], x, cfg.norm_eps)
    ws = [params[f"{p}_{g}"].to(COMPUTE_DTYPE) for p in "wb" for g in GATES]

    def gate_inputs(xn, *ws):
        xg = torch.cat([torch.einsum("bsd,dk->bsk", xn, w) + b
                        for w, b in zip(ws[:4], ws[4:])], dim=-1)
        # (B,S,4D) in [z|i|f|o] x (head, hd) order -> (S, B, H, 4, hd) fp32
        return xg.float().reshape(xn.shape[0], s, 4, heads, hd).permute(
            1, 0, 3, 2, 4)
    w = ws[0]
    if isinstance(w, DTensor) \
            and heads % mesh_sizes(w.device_mesh).get("model", 1):
        # a model axis that does not divide the heads shards the gates'
        # (head, hd) group, which no DTensor reshape can split: the gates
        # are computed whole on every rank of it, as the recurrence is
        xg = on_local_shards(gate_inputs, [(xn, 0, None),
                                           *((t, None, None) for t in ws)],
                             (1, 2), heads=heads)
    else:
        xg = gate_inputs(xn, *ws)
    if cache is not None:
        carry = tuple(cache[k] for k in ("c", "n", "h", "m"))
    else:
        zeros = torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, torch.full_like(zeros, -math.inf))
    # the recurrence is independent per batch row and head: under a policy
    # it runs on each rank's local shards (its weights stacked there)
    h_seq, *carry = on_local_shards(
        _slstm_scan, [*((params[f"r_{g}"], None, 0) for g in GATES),
                      (xg, 1, 2), *((t, 0, 1) for t in carry)],
        ((0, 2),) + ((0, 1),) * 4, heads=heads)     # h_seq (B,S,H,hd) fp32
    new_cache = {k: v.reshape(bsz, d) for k, v in zip(("c", "n", "h", "m"),
                                                       carry)}
    h_seq = rmsnorm(params["head_norm"], h_seq, cfg.norm_eps)
    out = torch.einsum("bsd,dk->bsk",
                       merge_heads(h_seq).to(COMPUTE_DTYPE),
                       params["w_out"].to(COMPUTE_DTYPE))
    return shard(out, "batch", "seq", "act_embed"), new_cache


def slstm_cache_init(cfg, batch, device):
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "m": torch.full((batch, d), -math.inf, dtype=torch.float32,
                        device=device),
    }
