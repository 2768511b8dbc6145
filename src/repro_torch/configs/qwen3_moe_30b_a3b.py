"""Qwen3-30B-A3B — MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=64,
    activation="swiglu",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    subquadratic=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
