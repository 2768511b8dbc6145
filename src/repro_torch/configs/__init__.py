"""Architecture config registry.

``get_config(name)`` returns the full published config; ``get_reduced(name)``
returns a tiny same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, XLSTMConfig, ShapeConfig,
    SHAPES, SMOKE_SHAPE, shape_applicable, reduce_config,
)

_MODULES = {
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    # the paper's own second model (not in the assigned pool, used by serving
    # benchmarks):
    "llama-3.1-70b": "repro_torch.configs.llama31_70b",
}

ASSIGNED_ARCHS = [k for k in _MODULES if k != "llama-3.1-70b"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduce_config(get_config(name), **overrides)


def all_cells():
    """Yield every applicable (arch, shape) dry-run cell."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape_applicable(cfg, shape):
                yield arch, shape.name
