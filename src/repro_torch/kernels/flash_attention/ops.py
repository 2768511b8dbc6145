"""Causal GQA flash attention, the forward of the teacher-forced loss: the
CUDA kernel's wrapper and its plain PyTorch version.

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
limit.  fp32 runs a scalar loop, one row a thread.

The JAX package has no gradient for this kernel (``jax.grad`` through
``flash_attention`` fails), so its ``Trainer`` trains with
``use_flash=False``; the port has no backward either, and
:func:`flash_attention` raises where autograd would need one.  It takes the
plain version for a tensor on the CPU and launches the kernel for a CUDA
tensor; anything else raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (check_cuda_inputs,
                                                      raise_on_launch_error,
                                                      reject_dtensor)

HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib, fn


def flash_attention(q, k, v, *, causal=True):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) with H = K*G and T >= S.  Returns
    (B,S,H,hd) in q's dtype.

    A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor
    launches the kernel (bf16 or fp32, any G, hd in 32/64/96/128,
    contiguous) or raises.  Raises when autograd would need a gradient."""
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
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{list(_DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel built for head_dim "
                         f"{hd} (built: {HEAD_DIMS})")
    check_cuda_inputs("flash_attention", (q, k, v), dtype=q.dtype)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, kh, h // kh, hd, int(causal), _DTYPES[q.dtype],
                stream)
    raise_on_launch_error(lib, "flash_attention", rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches since the last reset
