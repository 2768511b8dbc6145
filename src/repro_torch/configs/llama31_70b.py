"""Llama-3.1-70B — the paper's second serving model (Section 7.3).
[arXiv:2407.21783; hf:nvidia/Llama-3.1-70B-Instruct-FP8]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.1-70b",
    family="dense",
    num_layers=80,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    activation="swiglu",
    rope_theta=500_000.0,
    subquadratic=False,
    source="arXiv:2407.21783; hf",
)
