"""Phi-3-vision 4.2B — phi3-mini backbone + CLIP frontend (stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (num_patches × frontend_dim) that a learned
projection maps into the token stream as a prefill prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3_072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8_192,
    vocab_size=32_064,
    head_dim=96,
    activation="swiglu",
    frontend="vision",
    num_patches=576,           # CLIP ViT-L/14 @ 336px grid
    frontend_dim=1_024,        # CLIP hidden size
    subquadratic=False,
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
