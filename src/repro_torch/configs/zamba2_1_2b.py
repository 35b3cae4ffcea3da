"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64. Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

Copied from ``src/repro/configs/zamba2_1_2b.py``.  Zamba2 pattern: every
`shared_attn_every` mamba layers, one weight-tied transformer block (full
MHA kv=32 + MLP d_ff=8192) is applied.
"""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMCfg(d_state=64, expand=2, head_dim=64, conv_width=4, chunk=256),
    shared_attn_every=6,
    rope_theta=10_000.0,
    notes="runs long_500k: attention only in shared blocks (KV sharded S over data)",
)
