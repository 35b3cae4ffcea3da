"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

40 heads do not divide the 16-way model axis -> attention runs
sequence-parallel (SP) while the MLP stays tensor-parallel; decided by
the JAX package's distributed/rules.py, see DESIGN.md §7.

Copied from ``src/repro/configs/qwen2_5_14b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    grad_accum_microbatches=4,
)
