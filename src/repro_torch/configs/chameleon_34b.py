"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early-fusion VQ image tokens: image patches are quantized into the shared
65536-entry vocabulary, so the backbone consumes ordinary token ids; the
VQ tokenizer frontend is a STUB per the assignment (input_specs provides
token ids that stand in for interleaved text+image streams).
[arXiv:2405.09818; unverified]

Copied from ``src/repro/configs/chameleon_34b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,  # chameleon uses qk-norm for training stability
    rope_theta=10_000.0,
    grad_accum_microbatches=8,
)
