"""Causal GQA flash attention, the forward of the teacher-forced loss and
of a prompt pass over its live keys (T >= S, the diagonal shifted by T -
S): the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``flash_attention_pallas`` (src/repro/kernels/flash_attention/
flash_attention.py:80).  At the loss's shape (B=2, S=T=2048, H=24, K=8,
hd=128, bf16) it is bound by the tensor cores: 5.2e10 causal operations,
0.052 ms at 989 TFLOP/s, against 0.020 ms for its 67 MB at 3.35 TB/s.  In
bf16 one persistent thread block per SM walks tasks of 128 rows of
(query, head) pairs of one (batch, KV head), longest first: a producer warp
streams 128-key K/V tiles with TMA into a two-stage ring (each tile serves
the G heads of the group), and two consumer warpgroups run both products
on ``wgmma`` with the online softmax in registers, up to each task's causal
limit.

fp32 (``csrc/flash_attention_f32.cuh``) keeps its products on the CUDA
cores, since no tensor-core type holds 2e-5; it is bound by fp32 FMAs at 67
TFLOP/s, and by shared memory when a thread loads one float per FMA.  A
task is 64 flattened rows of one (batch, KV head) and a range of keys, on
128 threads: register micro-tiles of 4 rows x 4 keys (S; 8 at hd 32) and
4 rows x hd/8 columns (P V), fed by float4 loads, with 32-key K/V tiles
(64 at hd 32) double-buffered by ``cp.async``.  Where the row blocks alone
would leave the card's SMs idle, :func:`split_plan` cuts each row block's
causal keys into chunks (64 keys at ``bench_kernels.py``'s shape); each
chunk writes a partial (m, l, acc) to scratch from ``torch.empty`` and a
second kernel merges them.  Nothing persists between launches.

The JAX package has no gradient for this kernel (``jax.grad`` through
``flash_attention`` fails), so its ``Trainer`` trains with
``use_flash=False``; the port has no backward either, and
:func:`flash_attention` raises where autograd would need one.  It takes the
plain version for a tensor on the CPU and launches the kernel for a CUDA
tensor; anything else raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (check_cuda_inputs,
                                                      raise_on_launch_error,
                                                      reject_dtensor)

HEAD_DIMS = (32, 64, 96, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal=True):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) with H = K*G.  The dense softmax with
    fp32 scores and the -1e30 fill; the causal diagonal is shifted by T - S
    (key t is visible to query s iff t <= s + T - S).  Returns (B,S,H,hd)
    in q's dtype."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    if causal:
        qi = torch.arange(s, device=q.device)[:, None]
        ki = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(~(ki <= qi + (t - s)), -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


# fp32: flattened (query, head) rows per task, and the shortest key chunk
# (two of the kernel's 32-key tiles) when the row blocks alone do not give
# the card two tasks an SM
F32_ROWS = 64
F32_MIN_CHUNK = 64


@dataclass(frozen=True)
class FlashSplitPlan:
    """How the fp32 kernel cuts a launch: each row block of F32_ROWS
    flattened rows of one (batch, KV head) walks its keys in chunks of
    ``chunk``, over ``chunks`` task slots (enough for the row block with
    the most keys); ``scratch`` fp32 elements hold the chunks' partial
    (m, l, acc) states (0: one chunk a row block, written to ``out``
    directly).  The kernel derives each row block's keys and the task
    order from these integers itself."""
    chunk: int
    chunks: int
    scratch: int


@functools.lru_cache(maxsize=256)
def split_plan(batch, seq_q, seq_kv, num_kv, group, head_dim, causal, sms):
    """The fp32 kernel's plan for ``batch`` x ``num_kv`` (batch, KV head)
    pairs of ``seq_q`` queries of ``group`` heads over ``seq_kv`` keys on a
    card of ``sms`` SMs: one chunk a row block when the row blocks give at
    least two tasks an SM, else the longest chunk of F32_MIN_CHUNK x 2^i
    keys that still does (F32_MIN_CHUNK if none does), so the partials
    stay few.  A row block with one chunk writes ``out`` itself; the
    others write partials that a second kernel merges."""
    rows = seq_q * group
    n_rb = -(-rows // F32_ROWS)
    off = seq_kv - seq_q
    # keys [0, n) of each row block: its last row's causal limit
    row_keys = [
        min(seq_kv, (min(rows, (rb + 1) * F32_ROWS) - 1) // group + off + 1)
        if causal else seq_kv for rb in range(n_rb)]
    pairs, longest = batch * num_kv, max(row_keys)

    def tasks(chunk):
        return pairs * sum(-(-n // chunk) for n in row_keys)
    chunk = longest
    if pairs * n_rb < 2 * sms:
        chunk = F32_MIN_CHUNK
        while 2 * chunk < longest and tasks(2 * chunk) >= 2 * sms:
            chunk *= 2
    chunks = -(-longest // chunk)
    scratch = (pairs * n_rb * chunks * F32_ROWS * (head_dim + 2)
               if chunks > 1 else 0)
    return FlashSplitPlan(chunk, chunks, scratch)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib, fn


def _f32_launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_f32_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return lib, fn


def flash_attention(q, k, v, *, causal=True):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) with H = K*G and T >= S.  Returns
    (B,S,H,hd) in q's dtype.

    A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor
    launches the kernel (bf16 or fp32, any G, hd in 32/64/96/128,
    contiguous) or raises; fp32 takes :func:`split_plan`'s split with its
    scratch from ``torch.empty``.  Raises when autograd would need a
    gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no gradient: the JAX package has none for "
            "its flash kernel either (jax.grad through flash_attention "
            "fails), so training runs with use_flash=False")
    b, s, h, hd = q.shape
    _, t, kh, _ = k.shape
    if k.shape != (b, t, kh, hd) or v.shape != k.shape or kh < 1 or h % kh:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if t < s:
        raise ValueError(f"flash_attention: {t} keys for {s} queries; the "
                         f"kernel needs T >= S")
    reject_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel built for head_dim "
                         f"{hd} (built: {HEAD_DIMS})")
    check_cuda_inputs("flash_attention", (q, k, v), dtype=q.dtype)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.float32:
            plan = split_plan(b, s, t, kh, h // kh, hd, bool(causal),
                              _sm_count(q.device.index))
            partial = torch.empty(plan.scratch, dtype=torch.float32,
                                  device=q.device)
            lib, fn = _f32_launcher()
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    partial.data_ptr(), b, s, t, kh, h // kh, hd,
                    int(causal), plan.chunk, plan.chunks, stream)
        else:
            lib, fn = _launcher()
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, s, t, kh, h // kh, hd, int(causal), 1,  # bf16
                    stream)
    raise_on_launch_error(lib, "flash_attention", rc, "flash_attention")
    flash_attention.launches += 1
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    return out


flash_attention.launches = 0       # kernel launches since the last reset
flash_attention.launches_f32 = 0   # of them, fp32 launches
