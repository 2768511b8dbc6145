"""Ragged single-token GQA decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``decode_attention_pallas`` (src/repro/kernels/decode_attention/
decode_attention.py:61).  It is bound by the bytes of K and V below each
row's length, read once at 3.35 TB/s on an H100; one thread block per
(slot, KV head) holds the G query heads of the group in registers and
streams the slot's valid rows with 16-byte loads, skipping every row past
the length (see ``csrc/decode_attention_common.cuh``).

:func:`decode_attention` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
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


def _launcher():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib, fn


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,T,K,hd); lengths: (B,) int32.  Returns (B,H,hd).

    A CPU tensor takes :func:`decode_attention_plain`; a CUDA tensor
    launches the kernel (bf16 or fp32, H/K from 1 to 8, hd in 32/64/128,
    contiguous) or raises.  Lengths are clamped to [0, T]; rows with
    ``length == 0`` return zeros (inactive serving slots)."""
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
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, t, kh, h // kh, hd, _DTYPES[q.dtype],
                stream)
    raise_on_launch_error(lib, "decode_attention", rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches since the last reset
