"""Ragged single-token GQA decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``decode_attention_pallas`` (src/repro/kernels/decode_attention/
decode_attention.py:61).  It is bound by the bytes of K and V below each
row's length, read once at 3.35 TB/s on an H100.  It splits each slot's
keys into chunks of SPLIT_KEYS (flash-decoding, ``csrc/decode_split.cuh``):
one thread block per (chunk, KV head, slot) streams its chunk's K and V
rows into shared memory by ``cp.async`` on a 2-stage ring of 64-row tiles,
attends the G query heads of the group to them, and the last block of
each (slot, KV head) combines the chunks' partial softmax states in chunk
order, in the same launch.  Chunks past a slot's length do no work.
:func:`split_plan` sizes the chunks and the scratch; the combine counters
(:func:`_counters`) are one buffer per device, shared with the paged
kernel.

:func:`decode_attention` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 96, 128)
MAX_GROUP = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,T,K,hd); lengths: (B,) valid KV entries.
    Returns (B,H,hd) in q's dtype: the dense masked softmax in fp32.  Rows
    with ``length == 0`` return zeros, as the kernel's empty online softmax
    does."""
    b, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    lengths = lengths.to(q.device)
    qf = q.float().reshape(b, kh, g, hd)
    scores = torch.einsum("bkgh,btkh->bkgt", qf, k.float()) / math.sqrt(hd)
    mask = (torch.arange(t, device=q.device)[None, None, None, :]
            < lengths[:, None, None, None])
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v.float())
    out = torch.where(lengths[:, None, None, None] > 0, out, 0.0)
    return out.reshape(b, h, hd).to(q.dtype)


def reject_dtensor(name, *tensors):
    """Raise for a ``DTensor``: a kernel takes each rank's local shards
    (the model hands them over, ``models.layers.on_local_shards``) and
    has no distributed form, plain version included."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; pass each rank's local "
                        f"shard")


def check_cuda_inputs(name, tensors, *, dtype, int_tensors=()):
    """Raise unless every tensor is a contiguous, 16-byte aligned tensor of
    ``dtype`` (int32 for ``int_tensors``) on one CUDA device."""
    dev = tensors[0].device
    for t in (*tensors, *int_tensors):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data not 16-byte aligned")
    for t in int_tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: index dtype {t.dtype}, expected int32")


def check_shape(name, h, kh, hd, dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype} not in {list(_DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if kh < 1 or h % kh or not 1 <= h // kh <= MAX_GROUP:
        raise ValueError(f"{name}: {h} query heads over {kh} KV heads; "
                         f"the group must be 1..{MAX_GROUP}")


def raise_on_launch_error(lib, prefix, rc, name):
    if rc == -1:
        raise ValueError(f"{name}: no kernel built for these shapes")
    if rc != 0:
        err = getattr(lib, f"{prefix}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


# Keys per split, two tiles of the kernel's ring: on an H100 faster at the
# decode batch than 64 (see csrc/decode_attention.cu).
SPLIT_KEYS = 128


@dataclass(frozen=True)
class SplitPlan:
    """How a split-KV decode kernel cuts each slot's keys: ``chunk`` keys
    per split, ``splits`` splits per slot, partial softmax states of shape
    ``partial_shape`` (fp32) and ``counters`` combine counters."""
    chunk: int
    splits: int
    partial_shape: tuple
    counters: int


@functools.lru_cache(maxsize=256)
def split_plan(batch, seq_len, num_kv, group, head_dim):
    """The split plan of a launch over ``batch`` slots of ``seq_len`` keys,
    ``num_kv`` KV heads of ``group`` query heads and ``head_dim``: chunks of
    SPLIT_KEYS keys, as many as cover the cache.  A slot's splits past its
    length do no work."""
    splits = max(1, -(-seq_len // SPLIT_KEYS))
    return SplitPlan(SPLIT_KEYS, splits,
                     (batch, num_kv, splits, group * (head_dim + 2)),
                     batch * num_kv)


# device -> int32 combine counters of the split-KV kernels (dense and
# paged); every launch leaves them at zero.  Launches on one device share
# them, so they must be ordered (one stream).  A buffer outgrown by a wider
# launch stays allocated in _OUTGROWN: a CUDA graph that recorded a launch
# holds its address.
_COUNTERS = {}
_OUTGROWN = []


def _counters(device, n):
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
    return lib, fn


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,T,K,hd); lengths: (B,) int32.  Returns (B,H,hd).

    A CPU tensor takes :func:`decode_attention_plain`; a CUDA tensor
    launches the kernel (bf16 or fp32, H/K from 1 to 8, hd in HEAD_DIMS,
    contiguous) or raises.  The kernel's grid is :func:`split_plan`'s
    (splits, K, B); its partial states go to scratch from ``torch.empty``
    and its combine counters are the device's shared buffer.  Lengths are
    clamped to [0, T]; rows with ``length == 0`` return zeros (inactive
    serving slots)."""
    reject_dtensor("decode_attention", q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    b, h, hd = q.shape
    _, t, kh, _ = k.shape
    check_shape("decode_attention", h, kh, hd, q.dtype)
    if k.shape != (b, t, kh, hd) or v.shape != k.shape \
            or lengths.shape != (b,):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    check_cuda_inputs("decode_attention", (q, k, v), dtype=q.dtype,
                      int_tensors=(lengths,))
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out.zero_()
    plan = split_plan(b, t, kh, h // kh, hd)
    partial = torch.empty(plan.partial_shape, dtype=torch.float32,
                          device=q.device)
    counters = _counters(q.device, plan.counters)
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, t, kh, h // kh, hd, _DTYPES[q.dtype],
                stream, partial.data_ptr(), counters.data_ptr(), plan.splits,
                plan.chunk)
    raise_on_launch_error(lib, "decode_attention", rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches since the last reset
