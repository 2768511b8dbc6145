"""xLSTM-125M — sLSTM + mLSTM blocks (7:1-style mix). [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections instead of a
separate FFN. mLSTM uses a chunked linear-attention formulation (TPU
adaptation); sLSTM keeps its sequential recurrence via lax.scan.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=192,
    activation="gelu",
    xlstm=XLSTMConfig(slstm_every=4, slstm_offset=3, chunk=64, proj_factor=2),
    subquadratic=True,
    source="arXiv:2405.04517; unverified",
)
