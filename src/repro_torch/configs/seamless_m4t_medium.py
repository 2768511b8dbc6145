"""SeamlessM4T-medium — encoder-decoder, multimodal (audio frontend stubbed).
[arXiv:2308.11596; hf]

The modality frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings of dim ``frontend_dim``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder layers
    num_encoder_layers=12,
    cross_attention=True,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4_096,
    vocab_size=256_206,
    head_dim=64,
    activation="gelu",
    frontend="audio",
    frontend_dim=160,          # stub: precomputed fbank-frame embedding dim
    subquadratic=False,
    source="arXiv:2308.11596; hf",
)
