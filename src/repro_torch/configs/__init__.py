"""Architecture config registry of the PyTorch port.

``get_config(name)`` returns the full published config; ``get_reduced(name)``
returns a tiny same-family config for CPU tests.  The registry holds the
architectures whose families the port runs: the attention-only dense
models (phi4-mini, the serving and training slices; stablelm-3b, the
training example's base; minitron-4b, nemotron-4-340b and the paper's own
llama-3.1-70b), the MoE family (qwen3-moe-30b-a3b, arctic-480b), the
hybrid Mamba/attention family (jamba-v0.1-52b) and the xLSTM family
(xlstm-125m).  The encoder-decoder and VLM architectures join as their
families are ported (ROADMAP.md).
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
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llama-3.1-70b": "repro_torch.configs.llama31_70b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduce_config(get_config(name), **overrides)
