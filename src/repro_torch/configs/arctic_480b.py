"""Snowflake Arctic 480B — MoE 128e top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4_864,
    vocab_size=32_000,
    head_dim=128,
    activation="swiglu",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4_864,
                  dense_residual=True, d_ff_dense=4_864),
    subquadratic=False,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
