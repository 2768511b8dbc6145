"""Nemotron-4-340B — dense GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]

The paper's primary serving model (Section 7.3, FP8 TP=8 in the original;
bf16 on TPU here).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    head_dim=192,
    activation="squared_relu",
    subquadratic=False,
    source="arXiv:2402.16819; unverified",
)
