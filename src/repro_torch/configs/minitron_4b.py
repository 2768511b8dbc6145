"""Minitron-4B — pruned Nemotron (squared-ReLU family). [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3_072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9_216,
    vocab_size=256_000,
    head_dim=128,
    activation="squared_relu",
    subquadratic=False,
    source="arXiv:2407.14679; hf",
)
