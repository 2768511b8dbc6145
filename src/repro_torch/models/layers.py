"""Core transformer layers on torch: RMSNorm, RoPE, GQA attention, MLPs.

Port of ``src/repro/models/layers.py``.  Parameters are plain dicts of
tensors with the reference's names and layouts (``wq`` is ``(d, H, hd)``,
``wo`` is ``(H, hd, d)``, ...).  Compute runs in bf16 (``COMPUTE_DTYPE``:
weights are cast to it before every projection), with fp32 norms, RoPE and
softmax, exactly where the reference takes them.

Caches are updated in place (the reference returns new arrays and the
engine donates the old ones; mutating the tensor is the same thing here).
Single-token cached decode picks its attention with ``decode_impl``:

* ``"pallas"``: the hand-written CUDA decode kernel
  (``repro_torch.kernels.decode_attention``); the name is the reference's,
  kept so configurations carry across unchanged;
* ``"sdpa"``: the plain masked-softmax path over the dense cache;
* ``"paged"``: the CUDA paged-decode kernel over the global page pool
  (``repro_torch.kernels.paged_attention``);
* ``"paged_sdpa"``: gathers the slot's pages to a dense view and runs the
  plain causal path.

The no-cache causal call of the teacher-forced loss runs the CUDA flash
kernel (``repro_torch.kernels.flash_attention``) under ``use_flash``, on the
reference's condition (S == T and S % 128 == 0), else ``_sdpa_chunked``.
The encoder's bidirectional self-attention (``causal=False``) and the
decoder's cross attention (``kv_source``, no RoPE) always take the plain
``_sdpa_chunked`` under a ``'full'`` or ``'length'`` mask, as in the
reference.

On a CPU tensor the kernel wrappers run their plain PyTorch versions.

Under a sharding policy (``repro_torch.sharding``) the parameters and
caches are ``DTensor``s on a ``DeviceMesh`` and :func:`shard` redistributes
the activations at the reference's sites; with no policy it returns its
input and the layers compute on plain tensors.  Attention itself, the
kernels and the plain ``_sdpa_chunked`` alike, runs on each rank's local
shards (:func:`on_local_shards`): batch over the data axes, heads over
``model`` where the KV heads divide it, else whole heads.
"""
from __future__ import annotations

import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import shard
from repro_torch.sharding.policy import mesh_sizes

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (gather_pages,
                                                     paged_attention)
from repro_torch.models import runtime_flags as flags

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30

# Queries are processed in blocks of this length so the (S x T) score matrix
# is never fully materialised (reference layers.py:103);
# ``runtime_flags.Q_CHUNK_OVERRIDE`` replaces it when set.
Q_CHUNK = 1024


def _init(generator, shape, scale, dtype, device):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------- norms ----

def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-5):
    """fp32 statistics, result in the input dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * params["scale"].float()).to(dt)


# ----------------------------------------------------------------- rope ----

def rope_table(positions, head_dim, theta):
    """positions: int (..., S) -> (cos, sin) each (..., S, head_dim//2) fp32.
    The frequencies are computed in numpy float32, as the reference does."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B,S,H,hd); cos/sin: (B,S,half) or (S,half).  Half-split (not
    interleaved) rotation in fp32, returned in x's dtype."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----

def attention_init(generator, cfg, dtype, device):
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    s_in = d ** -0.5
    s_out = (h * hd) ** -0.5
    return {
        "norm": rmsnorm_init(d, dtype, device),
        "wq": _init(generator, (d, h, hd), s_in, dtype, device),
        "wk": _init(generator, (d, k, hd), s_in, dtype, device),
        "wv": _init(generator, (d, k, hd), s_in, dtype, device),
        "wo": _init(generator, (h, hd, d), s_out, dtype, device),
    }


def _sdpa(q, k, v, mask, q_per_kv):
    """q: (B,S,H,hd); k,v: (B,T,K,hd); mask broadcastable to (B,K,G,S,T).
    Scores in fp32 with the -1e30 fill; the probabilities are cast to the
    value dtype before the PV product (reference layers.py:86-97)."""
    b, s, h, hd = q.shape
    kheads = k.shape[2]
    q = q.reshape(b, s, kheads, q_per_kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, qpos, q_per_kv, *, kind, kv_lengths=None,
                  q_chunk=None):
    """Memory-bounded attention, ``q_chunk`` queries at a time (reference
    layers.py:106-137); without ``q_chunk``, ``Q_CHUNK_OVERRIDE or
    Q_CHUNK``, read at call time.  kind: ``'causal'`` (kv_pos <= q_pos),
    ``'full'`` (no mask) or ``'length'`` (kv_pos < kv_lengths, unmasked
    without ``kv_lengths``).  qpos: (B,S) int query positions; kv_lengths: (B,)."""
    if q_chunk is None:
        q_chunk = flags.Q_CHUNK_OVERRIDE or Q_CHUNK
    s = q.shape[1]
    kv_pos = torch.arange(k.shape[1], device=q.device)

    def block(q_blk, qp_blk):
        mask = None
        if kind == "causal":
            mask = (kv_pos[None, None, None, None, :]
                    <= qp_blk[:, None, None, :, None])
        elif kind == "length" and kv_lengths is not None:
            lens = kv_lengths.to(q.device)
            mask = (kv_pos[None, None, None, None, :]
                    < lens[:, None, None, None, None])
        return _sdpa(q_blk, k, v, mask, q_per_kv)

    if s <= q_chunk:
        return block(q, qpos)
    return torch.cat([block(q[:, i:i + q_chunk], qpos[:, i:i + q_chunk])
                      for i in range(0, s, q_chunk)], dim=1)


def _project_out(out, params):
    """The output projection and its sharding site, the one the reference
    takes after each of its four (layers.py:225, 265, 274, 282)."""
    out = head_einsum("bshk,hkd->bsd", out, params["wo"].to(COMPUTE_DTYPE),
                      w_heads=0, x_heads=2)
    return shard(out, "batch", "seq", "act_embed")


def merge_heads(x):
    """x (..., H, hd) -> (..., H * hd).  DTensor of torch 2.11 cannot
    flatten a group whose inner dim is sharded, so a head_dim sharded over
    a mesh axis (where the heads do not divide it) is gathered first."""
    if isinstance(x, DTensor):
        place = [Replicate() if isinstance(p, Shard) and p.dim == x.dim() - 1
                 else p for p in x.placements]
        if place != list(x.placements):
            x = x.redistribute(x.device_mesh, place)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def head_einsum(eq, x, w, *, w_heads, x_heads=None, out_heads=None):
    """``torch.einsum(eq, x, w)``, batch first in ``x`` and the result,
    for a weight ``w`` with a heads dim (``w_heads``; ``x_heads`` and
    ``out_heads`` the operand's and result's, where they have one).  Where
    the model axis does not divide the heads, the weight is laid out on
    head_dim (``kv_head_dim``) and the product would flatten a dim sharded
    inside the (heads, head_dim) group, which DTensor of torch 2.11 refuses
    and 2.13 cannot always undo; such a product runs on local shards
    (:func:`on_local_shards`): the weight whole on every rank, the batch
    split over the data axes, every rank computing all heads, as the
    attention core then does.  Otherwise DTensor's own product."""
    heads = w.shape[w_heads]
    if not isinstance(w, DTensor) \
            or heads % mesh_sizes(w.device_mesh).get("model", 1) == 0:
        return torch.einsum(eq, x, w)
    return on_local_shards(lambda a, b: torch.einsum(eq, a, b),
                           [(x, 0, x_heads), (w, None, w_heads)],
                           (0, out_heads), heads=heads)


_DATA_AXES = ("pod", "data")

# How :func:`on_local_shards` calls its ``fn``: ``call(fn, tensors, split)``,
# where ``split`` is the number of ranks that share the work (each computes
# 1/split of it, or all of it where split is 1).  The plain call unless the
# cost counter (``repro_torch.launch.jaxpr_cost``) installs its own, to
# count the local ops at the global shapes.
LOCAL_CALL = contextvars.ContextVar(
    "local_call", default=lambda fn, tensors, split: fn(*tensors))


def on_local_shards(fn, args, outs, *, heads):
    """``fn(*tensors)`` for a computation that is independent per batch
    row and head (attention, the Mamba scan).  ``args`` are (tensor, batch
    dim, head dim) with ``None`` for a dim the tensor lacks; ``outs`` the
    (batch dim, head dim) of each output (a tuple of them for a tuple).
    With no ``DTensor`` among the args, the call itself.  Else each rank
    calls ``fn`` on its local shards, contiguous, and the outputs form
    DTensors again: batch over the data axes where it divides them, and
    every head dim over ``model`` where ``heads`` (the count that must
    split evenly: the KV heads of a GQA attention) divides it, so each
    rank's query groups stay with their KV head and the local call is
    exact.  Where it does not divide, the tensors laid out on head_dim
    (``kv_head_dim``) are gathered over ``model`` here and every rank of it
    computes all heads.  Plain tensors among the args (positions, lengths)
    hold the same value on every rank and are split like the others."""
    mesh = next((t.device_mesh for t, _, _ in args
                 if isinstance(t, DTensor)), None)
    if mesh is None:
        return fn(*(t for t, _, _ in args))
    sizes = mesh_sizes(mesh)
    data = math.prod(sizes.get(a, 1) for a in _DATA_AXES)
    batch = next(t.shape[b] for t, b, _ in args if b is not None)
    by_batch = batch % data == 0
    by_heads = heads % sizes.get("model", 1) == 0

    def split(axis, batch_dim, head_dim):
        """What splits the computation over ``axis``: the tensor's own dim
        there, or None where the tensor is whole but the work is split."""
        if axis in _DATA_AXES and by_batch:
            return batch_dim
        return head_dim if axis == "model" and by_heads else ()

    def layout(batch_dim, head_dim):
        return [Replicate() if split(a, batch_dim, head_dim) in ((), None)
                else Shard(split(a, batch_dim, head_dim))
                for a in mesh.mesh_dim_names]

    def local(x, batch_dim, head_dim):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        place = layout(batch_dim, head_dim)
        # a tensor whole on an axis that splits the work (A_log over the
        # data shards, the Mamba's B and C over the heads) gets a partial
        # gradient from each rank there
        grad = [Partial() if split(a, batch_dim, head_dim) is None else p
                for a, p in zip(mesh.mesh_dim_names, place)]
        return x.redistribute(mesh, place).to_local(
            grad_placements=grad).contiguous()

    ranks = (data if by_batch else 1) * (sizes.get("model", 1)
                                         if by_heads else 1)
    out = LOCAL_CALL.get()(fn, [local(t, b, h) for t, b, h in args], ranks)
    if isinstance(outs[0], int):
        return DTensor.from_local(out, mesh, layout(*outs), run_check=False)
    return tuple(DTensor.from_local(o, mesh, layout(*d), run_check=False)
                 for o, d in zip(out, outs))


def _attend_local(fn, q, kvs, rows=(), *, kv_batch=True):
    """``fn(q, *kvs, *rows)`` on local shards (:func:`on_local_shards`):
    q (B, ..., H, hd) and K/V (..., K, hd) by their heads at dim -2, K/V by
    batch too unless ``kv_batch`` is False (a paged pool, which each rank
    takes whole), ``rows`` (positions, lengths, page table) by batch; the
    output is shaped like q."""
    hq = q.dim() - 2
    args = [(q, 0, hq),
            *((t, 0 if kv_batch else None, t.dim() - 2) for t in kvs),
            *((r, 0, None) for r in rows)]
    return on_local_shards(fn, args, (0, hq), heads=kvs[0].shape[-2])


def attention(params, x, cfg, *, positions=None, kv_cache=None,
              write_index=None, kv_source=None, causal=True, kv_lengths=None,
              use_rope=True, use_flash=False, decode_impl="sdpa",
              page_table=None):
    """General GQA attention (reference layers.py:140-282).

    x: (B,S,D) hidden states.
    positions: (S,) or (B,S) int query positions (RoPE and causal mask).
    kv_cache: dict(k=(B,T,K,hd), v=...), written in place: this call's K/V
        land at ``write_index``, a Python int (a slice of S rows, clamped
        into the cache as ``dynamic_update_slice`` clamps) or an int (B,)
        tensor (one row per batch entry, S must be 1; entries outside the
        cache write nothing).  Attention then spans the cache, masked by
        position.  Under a paged ``decode_impl`` the cache is the global page
        pool dict(k=(N,block,K,hd), v=...) indirected through ``page_table``
        (B, W) int32, and row b's position p lives in
        ``pool[page_table[b, p // block], p % block]``; unmapped entries
        point at the trash page 0.
    kv_source: (B,T,D): cross attention, K and V projected from it (not
        normalised) with no RoPE; mask ``'length'`` over ``kv_lengths``
        (B,) when given, else none.
    causal: without a cache or ``kv_source``, a causal or (False) a full,
        bidirectional mask.
    use_rope: RoPE on q and k (never on cross attention).
    use_flash: a causal call without a cache runs the flash kernel when S
        == T and S % 128 == 0 (reference layers.py:270); it has no gradient.
    decode_impl: see the module docstring; multi-token calls always take the
        plain path.
    Returns (out, kv_cache_or_None).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    g = cfg.q_heads_per_kv
    xn = rmsnorm(params["norm"], x, cfg.norm_eps)
    q = head_einsum("bsd,dhk->bshk", xn, params["wq"].to(COMPUTE_DTYPE),
                    w_heads=1, out_heads=2)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    src = xn if kv_source is None else kv_source.to(xn.dtype)
    k, v = (head_einsum("bsd,dhk->bshk", src, params[w].to(COMPUTE_DTYPE),
                        w_heads=1, out_heads=2) for w in ("wk", "wv"))

    if positions is None:
        positions = torch.arange(s, device=x.device)
    if use_rope and kv_source is None:
        cos, sin = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    qp = positions.to(torch.int32)
    qp = qp.expand(b, s) if qp.dim() == 1 else qp

    if kv_cache is not None and decode_impl in ("paged", "paged_sdpa"):
        if s != 1:
            raise ValueError("paged decode handles single-token steps only")
        if page_table is None:
            raise ValueError(f"decode_impl={decode_impl!r} needs a page_table")
        k = shard(k, "decode_batch", None, "kv_heads", "kv_head_dim")
        v = shard(v, "decode_batch", None, "kv_heads", "kv_head_dim")
        ck, cv = kv_cache["k"], kv_cache["v"]
        block = ck.shape[1]
        table = page_table.to(device=x.device, dtype=torch.int32)
        pos = qp[:, 0].long()
        # an index past the table reads its last entry, as the reference's
        # gather clamps
        col = torch.clamp(pos // block, max=table.shape[1] - 1)
        page = table[torch.arange(b, device=x.device), col].long()
        off = pos % block
        ck[page, off] = k[:, 0].to(ck.dtype)
        cv[page, off] = v[:, 0].to(cv.dtype)
        lengths = qp[:, 0] + 1
        if decode_impl == "paged":
            out = _attend_local(
                lambda q1, *a: paged_attention(q1.contiguous(), *a), q[:, 0],
                (ck, cv), (table, lengths), kv_batch=False)[:, None]
        else:
            kd = gather_pages(ck, table).to(COMPUTE_DTYPE)
            vd = gather_pages(cv, table).to(COMPUTE_DTYPE)
            out = _sdpa_chunked(q, kd, vd, qp, g, kind="causal")
        return _project_out(out, params), kv_cache

    if kv_cache is None:
        if kv_source is not None:
            kind = "length" if kv_lengths is not None else "full"
        elif not causal:
            kind = "full"
        elif use_flash and s == k.shape[1] and s % 128 == 0:
            out = _attend_local(
                lambda *a: flash_attention(*(t.contiguous() for t in a),
                                           causal=True), q, (k, v))
            return _project_out(out, params), None
        else:
            kind = "causal"
        lens = () if kv_lengths is None else (kv_lengths,)
        out = _attend_local(
            lambda q1, k1, v1, p1, *n: _sdpa_chunked(
                q1, k1, v1, p1, g, kind=kind, kv_lengths=n[0] if n else None),
            q, (k, v), (qp, *lens))
        return _project_out(out, params), None

    k = shard(k, "decode_batch", None, "kv_heads", "kv_head_dim")
    v = shard(v, "decode_batch", None, "kv_heads", "kv_head_dim")
    ck, cv = kv_cache["k"], kv_cache["v"]
    t = ck.shape[1]
    widx = 0 if write_index is None else write_index
    if isinstance(widx, torch.Tensor) and widx.dim() == 1:
        if s != 1:
            raise ValueError("a (B,) write_index needs single-token steps")
        widx = widx.to(device=x.device, dtype=torch.long)
        if isinstance(ck, DTensor):
            # a DTensor takes no index_put_ with a plain index: write as
            # the reference does, a select over T (layers.py:215-219)
            sel = (torch.arange(t, device=x.device)[None, :, None, None]
                   == widx[:, None, None, None])
            ck.copy_(torch.where(sel, k.to(ck.dtype), ck))
            cv.copy_(torch.where(sel, v.to(cv.dtype), cv))
        else:
            rows = torch.arange(b, device=x.device)
            inside = ((widx >= 0) & (widx < t))[:, None, None]
            at = widx.clamp(0, t - 1)
            ck[rows, at] = torch.where(inside, k[:, 0].to(ck.dtype),
                                       ck[rows, at])
            cv[rows, at] = torch.where(inside, v[:, 0].to(cv.dtype),
                                       cv[rows, at])
    else:
        start = min(max(int(widx), 0), t - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)

    if decode_impl == "pallas" and s == 1:
        lengths = qp[:, 0] + 1
        out = _attend_local(
            lambda q1, *a: decode_attention(q1.contiguous(), *a), q[:, 0],
            (ck, cv), (lengths,))[:, None]
        return _project_out(out, params), kv_cache

    out = _attend_local(
        lambda q1, k1, v1, p1: _sdpa_chunked(q1, k1, v1, p1, g, kind="causal"),
        q, (ck.to(COMPUTE_DTYPE), cv.to(COMPUTE_DTYPE)), (qp,))
    return _project_out(out, params), kv_cache


# ------------------------------------------------------------------ mlp ----

def mlp_init(generator, cfg, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    p = {"norm": rmsnorm_init(d, dtype, device)}
    if cfg.activation == "swiglu":
        p["wg"] = _init(generator, (d, f), d ** -0.5, dtype, device)
    p["wu"] = _init(generator, (d, f), d ** -0.5, dtype, device)
    p["wd"] = _init(generator, (f, d), f ** -0.5, dtype, device)
    return p


def mlp(params, x, cfg):
    xn = rmsnorm(params["norm"], x, cfg.norm_eps)
    h = torch.einsum("bsd,df->bsf", xn, params["wu"].to(COMPUTE_DTYPE))
    h = shard(h, "batch", "seq", "act_mlp")
    if cfg.activation == "swiglu":
        gate = torch.einsum("bsd,df->bsf", xn,
                            params["wg"].to(COMPUTE_DTYPE))
        h = F.silu(gate) * h
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out = torch.einsum("bsf,fd->bsd", h, params["wd"].to(COMPUTE_DTYPE))
    return shard(out, "batch", "seq", "act_embed")
