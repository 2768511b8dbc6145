"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Layer layout (period 8): attention at offset 4 within each period (as in the
published config: attn_layer_offset=4, attn_layer_period=8); MoE on every
second layer (expert_layer_period=2, offset=1).
Mamba layers use the Mamba-2 SSD chunked formulation (TPU adaptation).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    head_dim=128,
    activation="swiglu",
    attn_layer_period=8,
    attn_layer_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14_336,
                  every_k_layers=2, moe_layer_offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=128),
    subquadratic=True,
    source="arXiv:2403.19887; hf",
)
