"""Config dataclasses for models, shapes, serving and training.

Every assigned architecture gets a module in this package exporting
``CONFIG`` (the exact published numbers) and ``reduced()`` (a tiny
same-family config for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1        # MoE on layers with idx % every_k == offset
    moe_layer_offset: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    d_ff_dense: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2-style SSD block hyperparameters (TPU adaptation, see DESIGN.md)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4          # sLSTM at layer idx % every == offset
    slstm_offset: int = 3
    chunk: int = 64
    proj_factor: int = 2          # mLSTM up-projection factor


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "swiglu"     # swiglu | squared_relu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid layout: attention on layers with idx % period == offset; SSM otherwise
    attn_layer_period: int = 1
    attn_layer_offset: int = 0
    # encoder-decoder
    num_encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stubs
    frontend: Optional[str] = None  # 'audio' | 'vision'
    num_patches: int = 0            # vision/audio prefix length folded into seq
    frontend_dim: int = 0           # raw embedding dim from the (stubbed) frontend
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    subquadratic: bool = False      # True => long_500k shape is runnable
    source: str = ""                # provenance string from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.num_heads, 1)

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        h, k = self.num_heads, self.num_kv_heads
        n = self.vocab_size * d  # embedding
        if self.family == "ssm":
            x = self.xlstm or XLSTMConfig()
            di = x.proj_factor * d
            per_m = 2 * d * di + 3 * di * di // max(self.num_heads, 1) + di * d
            per_s = 4 * d * d + 4 * d * d // max(self.num_heads, 1)
            n_m = sum(1 for i in range(self.num_layers)
                      if i % x.slstm_every != x.slstm_offset)
            n += n_m * per_m + (self.num_layers - n_m) * per_s
            n += self.vocab_size * d  # untied output head
            return n
        attn = d * h * hd + 2 * d * k * hd + h * hd * d
        if self.activation == "swiglu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        n_layers_total = self.num_layers + self.num_encoder_layers
        for i in range(self.num_layers):
            is_attn = (i % self.attn_layer_period) == self.attn_layer_offset
            if is_attn or self.family != "hybrid":
                n += attn
            else:
                s = self.ssm or SSMConfig()
                di = s.expand * d
                n += d * (2 * di + 2 * s.d_state + di // s.head_dim) + di * d
            if self.moe and (i % self.moe.every_k_layers) == self.moe.moe_layer_offset:
                mult = 3 if self.activation == "swiglu" else 2
                n += self.moe.num_experts * mult * d * self.moe.d_ff_expert
                n += d * self.moe.num_experts
                if self.moe.dense_residual:
                    n += mult * d * self.moe.d_ff_dense
            elif self.d_ff > 0:
                n += mlp_dense
        for _ in range(self.num_encoder_layers):
            n += attn + mlp_dense
            if self.cross_attention:
                n += attn  # decoder cross-attention blocks
        n += self.vocab_size * d  # untied LM head
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.activation == "swiglu" else 2
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if (i % self.moe.every_k_layers) == self.moe.moe_layer_offset)
        all_e = n_moe_layers * self.moe.num_experts * mult * self.d_model * self.moe.d_ff_expert
        act_e = n_moe_layers * self.moe.top_k * mult * self.d_model * self.moe.d_ff_expert
        return full - all_e + act_e


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention; skip for full-attention archs."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid" else cfg.attn_layer_period),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff > 0 else 0,
        vocab_size=512,
        num_encoder_layers=2 if cfg.num_encoder_layers else 0,
        num_patches=16 if cfg.num_patches else 0,
        frontend_dim=64 if cfg.frontend_dim else 0,
    )
    if cfg.family == "hybrid":
        small["num_layers"] = cfg.attn_layer_period  # one full period
    if cfg.moe:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            d_ff_dense=64 if cfg.moe.dense_residual else 0)
    if cfg.ssm:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, head_dim=16, chunk=16)
    if cfg.xlstm:
        small["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=8)
        small["num_layers"] = 4
        small["num_kv_heads"] = 4
    small["name"] = cfg.name + "-reduced"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
