"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

GQA, 128k vocab. [arXiv:2407.21783; unverified]

Copied from ``src/repro/configs/llama3_405b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    optimizer="adafactor",        # 405B adam states do not fit one v5e pod
    grad_accum_microbatches=8,    # perf: halves FSDP re-gather traffic (§Perf)
    grad_accum_dtype="bfloat16",  # halve the 6.3 GiB/chip accum buffer
    param_dtype="bfloat16",       # T5X-style pure-bf16 + adafactor
    scan_block=9,                 # sqrt-remat: 14 saved residuals, not 126
    notes="adafactor + 16 microbatches + sqrt-remat to fit 16GiB/chip/pod",
)
