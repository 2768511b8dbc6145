"""PyTorch/CUDA port of the disaggregated-inference reproduction.

Laid out module for module like ``repro`` (the JAX package, which stays the
reference): every port module has one reference module of the same path.
The numpy-only modules (``core``, ``serving.control_plane``,
``serving.fabric``, ``serving.paging``, ``configs``) are copies; the rest are
ports onto ``torch``, with the TPU's Pallas kernels replaced by CUDA kernels
written for Hopper (``csrc/``).  Nothing here imports ``jax`` or ``repro``.

Entry points (``Model``, ``PrefillEngine``, ``DecodeEngine``,
``DisaggregatedCluster``) run on ``cuda`` unless the caller passes
``device="cpu"``; a default device on a machine without CUDA raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is given.
    Asking for CUDA where there is none raises; nothing falls back to the
    CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev
