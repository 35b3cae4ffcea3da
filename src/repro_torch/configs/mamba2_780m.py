"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality). [arXiv:2405.21060; unverified]
Copied from ``src/repro/configs/mamba2_780m.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMCfg(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    tie_embeddings=True,
    notes="vocab padded 50280->50432; runs long_500k (sub-quadratic)",
)
