"""Paged single-token GQA decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``paged_attention_pallas`` (src/repro/kernels/paged_attention/
paged_attention.py:66).  Like the dense kernel it is bound by the bytes of
the valid KV rows at 3.35 TB/s on an H100.  The pool is never gathered into
a dense per-slot view.  The kernel splits each slot's window into chunks of
whole pages (flash-decoding, ``csrc/decode_split.cuh``): one thread block
per (chunk, KV head, slot) reads its chunk's page ids once, clamping them
into the pool and the length to the table's window as the JAX wrapper does
(ops.py:35-37 there), and the last block of each (slot, KV head) combines
the chunks' partial softmax states in chunk order, in the same launch.
:func:`split_plan` sizes the chunks and the scratch.  Page 0 is the trash
page that unmapped entries point at.

:func:`paged_attention` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (
    _DTYPES, SplitPlan, _counters, check_cuda_inputs, check_shape,
    decode_attention_plain, raise_on_launch_error, reject_dtensor)


def gather_pages(pool, page_table):
    """pool: (N, block, K, hd); page_table: (B, W) int.  Returns the dense
    per-slot view (B, W*block, K, hd); entries are clamped into the pool."""
    n, block = pool.shape[0], pool.shape[1]
    table = page_table.to(device=pool.device, dtype=torch.long).clamp(0, n - 1)
    b, w = table.shape
    return pool[table].reshape(b, w * block, *pool.shape[2:])


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """q: (B,H,hd); pools (N, block, K, hd); page_table: (B, W); lengths:
    (B,).  Gathers the pages, then runs the dense plain version; lengths
    are clamped to W * block and length-0 rows return zeros."""
    block = k_pool.shape[1]
    w = page_table.shape[1]
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    lengths = torch.clamp(lengths.to(q.device), max=w * block)
    return decode_attention_plain(q, k, v, lengths)


# Keys per split on an H100: enough blocks with keys to keep every SM's
# loads in flight at the decode batch (see csrc/paged_attention.cu).
SPLIT_KEYS = 64
MAX_SPLIT_PAGES = 64      # page ids one block keeps (csrc/decode_split.cuh)


@dataclass(frozen=True)
class PagedSplitPlan(SplitPlan):
    """A :class:`SplitPlan` over a page table: each chunk is
    ``chunk_pages`` whole pages."""
    chunk_pages: int


@functools.lru_cache(maxsize=256)
def split_plan(batch, width, block, num_kv, group, head_dim):
    """The split plan of a launch over ``batch`` slots, ``width`` pages of
    ``block`` keys, ``num_kv`` KV heads of ``group`` query heads and
    ``head_dim``: whole pages of about SPLIT_KEYS keys per split, as many
    splits as cover the window.  A slot's splits past its length do no
    work."""
    pages = min(MAX_SPLIT_PAGES, max(1, SPLIT_KEYS // block))
    chunk = pages * block
    splits = max(1, -(-width // pages))
    return PagedSplitPlan(
        chunk=chunk, splits=splits,
        partial_shape=(batch, num_kv, splits, group * (head_dim + 2)),
        counters=batch * num_kv, chunk_pages=pages)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
    return lib, fn


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B,H,hd); k_pool, v_pool: (N, block, K, hd); page_table: (B, W)
    int32; lengths: (B,) int32.  Returns (B,H,hd).

    A CPU tensor takes :func:`paged_attention_plain`; a CUDA tensor
    launches the kernel or raises.  Table entries are clamped to [0, N-1]
    and lengths to [0, W * block]; rows with ``length == 0`` return zeros."""
    reject_dtensor("paged_attention", q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    b, h, hd = q.shape
    n, block, kh, _ = k_pool.shape
    w = page_table.shape[1] if page_table.dim() == 2 else -1
    check_shape("paged_attention", h, kh, hd, q.dtype)
    if k_pool.shape != (n, block, kh, hd) or v_pool.shape != k_pool.shape \
            or page_table.shape != (b, w) or lengths.shape != (b,):
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"table {tuple(page_table.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    check_cuda_inputs("paged_attention", (q, k_pool, v_pool), dtype=q.dtype,
                      int_tensors=(page_table, lengths))
    out = torch.empty_like(q)
    if b == 0 or n == 0 or w == 0:
        return out.zero_()
    plan = split_plan(b, w, block, kh, h // kh, hd)
    partial = torch.empty(plan.partial_shape, dtype=torch.float32,
                          device=q.device)
    counters = _counters(q.device, plan.counters)
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, n, block, w, kh, h // kh, hd, _DTYPES[q.dtype], stream,
                partial.data_ptr(), counters.data_ptr(), plan.splits,
                plan.chunk_pages)
    raise_on_launch_error(lib, "paged_attention", rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0    # kernel launches since the last reset
