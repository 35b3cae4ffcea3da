"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Copied from ``src/repro/configs/qwen3_moe_30b_a3b.py``.
"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=768, every=1),
    grad_accum_microbatches=16,
    scan_block=8,
)
