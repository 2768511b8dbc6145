"""Paged single-token GQA decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``paged_attention_pallas`` (src/repro/kernels/paged_attention/
paged_attention.py:66).  Like the dense kernel it is bound by the bytes of
the valid KV rows at 3.35 TB/s on an H100.  The pool is never gathered into
a dense per-slot view: each thread block reads its slot's page-table row
and walks the slot's pages in order, clamping entries into the pool and the
length to the table's window as the JAX wrapper does (ops.py:35-37 there).
Page 0 is the trash page that unmapped entries point at.

:func:`paged_attention` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (
    _DTYPES, check_cuda_inputs, check_shape, decode_attention_plain,
    raise_on_launch_error)


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


def _launcher():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib, fn


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """q: (B,H,hd); k_pool, v_pool: (N, block, K, hd); page_table: (B, W)
    int32; lengths: (B,) int32.  Returns (B,H,hd).

    A CPU tensor takes :func:`paged_attention_plain`; a CUDA tensor
    launches the kernel or raises.  Table entries are clamped to [0, N-1]
    and lengths to [0, W * block]; rows with ``length == 0`` return zeros."""
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
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, n, block, w, kh, h // kh, hd, _DTYPES[q.dtype], stream)
    raise_on_launch_error(lib, "paged_attention", rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0    # kernel launches since the last reset
