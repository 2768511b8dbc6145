"""The Mamba-2 (SSD) single-token decode step: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/ssd_step.cu``) replaces no Pallas kernel: the JAX
package's ``_ssd_step`` is plain ``jnp``.  It is added because the step is
bound by the bytes of its fp32 state, of which the plain version makes
about ten passes (the outer product, the decay, the sum, the readout's
layout copy and read, and the model's copy back into the cache) where one
read and one write do.  One thread block per (head, row) reads its state
tile once, decays it and adds the update, writes it back in place and
returns the readout from the values still in registers.  The new state
equals the plain step's bit for bit; the readout agrees to fp32 summation
order.

:func:`ssd_step` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; anything else raises.  On either
device it writes the new state into the state it was given and returns
that tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (raise_on_launch_error,
                                                      reject_dtensor)

HEAD_DIMS = (16, 32, 64, 128)        # P, the kernel's template widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_step_plain(x, dt, a_log, b_in, c_in, state):
    """The single-token recurrent step (S == 1): x (B,H,P), dt (B,H),
    b_in/c_in (B,G,N), group g's shared by heads g·H/G to (g+1)·H/G - 1,
    state (B,H,N,P) fp32 -> (y (B,H,P), new state), a new tensor."""
    a = torch.exp(-torch.exp(a_log.float()) * dt)                 # (B,H)
    bsz, h, p = x.shape
    g, n = b_in.shape[1:]
    dx = (dt[:, :, None] * x.float()).view(bsz, g, h // g, p)
    upd = torch.einsum("bgn,bghp->bghnp", b_in.float(),
                       dx).reshape(bsz, h, n, p)
    state = state * a[..., None, None] + upd
    y = torch.einsum("bgn,bghnp->bghp", c_in.float(),
                     state.view(bsz, g, h // g, n, p))
    return y.reshape(bsz, h, p), state


def check_inputs(x, dt, a_log, b_in, c_in, state):
    """Raise unless the kernel takes these: x (B,H,P) bf16 or fp32 with P
    in HEAD_DIMS; b_in, c_in (B,G,N) in x's dtype with G dividing H; each
    of the three contiguous within a row (the rows may lie at any stride,
    as slices of the block's projection do); dt (B,H) fp32 and a_log (H,)
    fp32 or bf16, contiguous; state (B,H,N,P) fp32, contiguous and 16-byte
    aligned, which the kernel overwrites; all on one device."""
    name = "ssd_step"
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 3 or b_in.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} and B "
                         f"{tuple(b_in.shape)} must be (B,H,P) and (B,G,N)")
    bsz, h, p = x.shape
    g, n = b_in.shape[1:]
    if p not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {p} not in {HEAD_DIMS}")
    if g < 1 or h % g:
        raise ValueError(f"{name}: {h} heads over {g} groups")
    shapes = {"dt": (dt, (bsz, h)), "a_log": (a_log, (h,)),
              "c_in": (c_in, (bsz, g, n)), "state": (state, (bsz, h, n, p))}
    for what, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, expected "
                             f"{want}")
    for what, t in (("x", x), ("b_in", b_in), ("c_in", c_in), ("dt", dt),
                    ("a_log", a_log), ("state", state)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
    for what, t in (("b_in", b_in), ("c_in", c_in)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {what} dtype {t.dtype}, x {x.dtype}")
    if dt.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"{name}: dt {dt.dtype} and state {state.dtype} "
                         f"must be fp32")
    if a_log.dtype not in _DTYPES:
        raise ValueError(f"{name}: a_log dtype {a_log.dtype} not in "
                         f"{list(_DTYPES)}")
    for what, t in (("x", x), ("b_in", b_in), ("c_in", c_in)):
        if not t[:1].is_contiguous():          # a row, at any row stride
            raise ValueError(f"{name}: {what} rows not contiguous, strides "
                             f"{t.stride()}")
    for what, t in (("dt", dt), ("a_log", a_log), ("state", state)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} not contiguous, strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    if state.data_ptr() % 16:
        raise ValueError(f"{name}: state not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("ssd_step")
    fn = lib.ssd_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    return lib, fn


def ssd_step(x, dt, a_log, b_in, c_in, state):
    """x (B,H,P), dt (B,H), a_log (H,), b_in/c_in (B,G,N), state
    (B,H,N,P) fp32 -> (y (B,H,P) fp32, state), the new state written into
    ``state``.

    A CPU tensor takes :func:`ssd_step_plain` and copies its state in.  A
    CUDA tensor launches the kernel (:func:`check_inputs` says what it
    takes, else it raises), which writes the state in place."""
    reject_dtensor("ssd_step", x, dt, a_log, b_in, c_in, state)
    if x.device.type == "cpu":
        y, new = ssd_step_plain(x, dt, a_log, b_in, c_in, state)
        return y, state.copy_(new)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_step: no kernel for {x.device}")
    check_inputs(x, dt, a_log, b_in, c_in, state)
    bsz, h, p = x.shape
    g, n = b_in.shape[1:]
    y = torch.empty((bsz, h, p), dtype=torch.float32, device=x.device)
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                int(a_log.dtype == torch.float32), b_in.data_ptr(),
                c_in.data_ptr(), state.data_ptr(), y.data_ptr(), bsz, h, g,
                n, p, _DTYPES[x.dtype], x.stride(0), b_in.stride(0),
                c_in.stride(0), stream)
    raise_on_launch_error(lib, "ssd_step", rc, "ssd_step")
    ssd_step.launches += 1
    return y, state


ssd_step.launches = 0   # kernel launches since the last reset
