"""StableLM-3B — dense MHA (kv=32). [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2_560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6_912,
    vocab_size=50_304,
    head_dim=80,
    activation="swiglu",
    subquadratic=False,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
