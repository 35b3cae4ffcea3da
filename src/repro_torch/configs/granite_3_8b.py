"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

Copied from ``src/repro/configs/granite_3_8b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000.0,
    grad_accum_microbatches=4,
    notes="vocab padded 49155->49408 for 256-alignment (DESIGN.md §7)",
)
