"""Architecture config registry of the PyTorch port.

``get_config(name)`` returns the full published config; ``get_reduced(name)``
returns a tiny same-family config for CPU tests.  The port runs the
attention-only dense family, so the registry holds phi4-mini (the serving
and training slices) and stablelm-3b (the training example's base); the
other architectures join as their model families are ported (ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig, ShapeConfig,
    SHAPES, SMOKE_SHAPE, shape_applicable, reduce_config,
)

_MODULES = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduce_config(get_config(name), **overrides)
