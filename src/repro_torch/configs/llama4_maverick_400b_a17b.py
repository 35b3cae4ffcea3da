"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1. MoE + early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Interleaved MoE (every 2nd layer) with a shared expert, per the Llama-4
architecture family; routed experts top-1 of 128.

Copied from ``src/repro/configs/llama4_maverick_400b_a17b.py``.
"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, every=2,
               shared_expert_ff=8192),
    optimizer="adafactor",
    grad_accum_microbatches=16,
    grad_accum_dtype="bfloat16",
    param_dtype="bfloat16",
    scan_block=6,
    notes="40 heads -> SP attention on 16-way model axis; experts EP-sharded",
)
