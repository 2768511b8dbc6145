"""Nemotron-H-47B-Base-8K — hybrid of Mamba-2, attention and MLP layers,
one sub-block a layer. [hf:nvidia/Nemotron-H-47B-Base-8K]

Each of the 98 layers is a pre-RMSNorm, one sub-block and the residual add;
``hybrid_override_pattern`` sets the sub-block layer by layer: ``M`` a
Mamba-2 mixer, ``-`` a squared-ReLU MLP, ``*`` GQA attention.  No layer has
both a mixer and an MLP.  The Mamba-2 mixer has 256 heads of 64 in 8
groups, each group of 32 heads sharing one B and one C of state 256; its
output is gated before its RMSNorm, which normalises each group's 2,048
channels apart.  The published config has no rotary key: attention runs
without positional encoding, the Mamba layers carrying the position.

The registry's ``ModelConfig`` (a copy of the JAX package's) places layers
by ``attn_layer_period`` and knows neither groups nor the gate-first norm,
so this module extends it: :class:`PatternConfig` carries the pattern and
the RoPE switch, :class:`GroupedSSMConfig` the groups and the norm order.
``repro_torch.models.model.Model`` lays its layers out by ``layer_pattern``
where a config has one.

``CONFIG`` is the published model; ``STAGE`` its first 19 layers, the
benchmark's one-card stage of a five-stage pipeline (``M-M-M-M-M-M-M-M-M*-``:
9 Mamba, 9 MLP and 1 attention layer); ``reduced()`` a tiny one for the
CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, SSMConfig

PATTERN = ("M-M-M-M-M-M-M-M-M*-M-M-M-M-M-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-"
           "M-M-M-M-M-M-M---MM---M-M*-M-M-M-M-M-")
STAGE_LAYERS = 19


@dataclass(frozen=True)
class GroupedSSMConfig(SSMConfig):
    """Mamba-2 with ``n_groups`` groups of B and C (head h takes group
    h // (heads / n_groups)); ``gate_then_norm``: the output times
    silu(z), then RMSNorm over each of ``n_groups`` groups of channels
    (the default, False, normalises the whole width and gates after)."""
    n_groups: int = 1
    gate_then_norm: bool = False


@dataclass(frozen=True)
class PatternConfig(ModelConfig):
    """A model whose layers follow ``layer_pattern``, one character a
    layer: ``M`` a Mamba mixer, ``-`` an MLP, ``*`` attention (RoPE on q
    and k where ``use_rope``)."""
    layer_pattern: str = ""
    use_rope: bool = True

    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        h, k = self.num_heads, self.num_kv_heads
        s = self.ssm
        di = s.expand * d
        nh = di // s.head_dim
        gn = 2 * s.n_groups * s.d_state
        per = {
            "*": 2 * d * h * hd + 2 * d * k * hd + d,
            "-": 2 * d * self.d_ff + d,
            "M": (d * (2 * di + gn + nh) + s.d_conv * (di + gn) + di + gn
                  + 3 * nh + d + di + di * d),
        }
        return (2 * self.vocab_size * d + d
                + sum(per[c] for c in self.layer_pattern))


CONFIG = PatternConfig(
    name="nemotron-h-47b",
    family="hybrid",
    num_layers=len(PATTERN),
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=30_720,
    vocab_size=131_072,
    head_dim=128,
    activation="squared_relu",
    ssm=GroupedSSMConfig(d_state=256, d_conv=4, expand=2, head_dim=64,
                         chunk=128, n_groups=8, gate_then_norm=True),
    norm_eps=1e-5,
    subquadratic=False,
    source="hf:nvidia/Nemotron-H-47B-Base-8K",
    layer_pattern=PATTERN,
    use_rope=False,
)

STAGE = dataclasses.replace(CONFIG, name="nemotron-h-47b-stage",
                            num_layers=STAGE_LAYERS,
                            layer_pattern=PATTERN[:STAGE_LAYERS])


def reduced(pattern: str = "M-*--M*M", **overrides) -> PatternConfig:
    """A tiny config of the same kind for the CPU tests: every layer kind,
    two MLP-only layers in a row, 4 Mamba heads of 16 in 2 groups, state 4,
    chunk 8."""
    small = dict(
        name="nemotron-h-reduced", num_layers=len(pattern), d_model=32,
        num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
        layer_pattern=pattern,
        ssm=GroupedSSMConfig(d_state=4, d_conv=4, expand=2, head_dim=16,
                             chunk=8, n_groups=2, gate_then_norm=True))
    small.update(overrides)
    return dataclasses.replace(CONFIG, **small)
