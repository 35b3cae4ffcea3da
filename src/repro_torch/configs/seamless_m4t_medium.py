"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206. Encoder-decoder, multimodal. [arXiv:2308.11596; hf]

The speech frontend (fbank conformer feature extractor) is a STUB per the
assignment: input_specs() provides precomputed frame embeddings of shape
(batch, frames, d_model). 12L = 6 encoder + 6 decoder transformer layers.
Decode shapes exercise the autoregressive text decoder (self-attn KV cache
+ cross-attention over encoder memory).

Copied from ``src/repro/configs/seamless_m4t_medium.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    enc_layers=6,
    dec_layers=6,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    embed_inputs=True,
    rope_theta=10_000.0,
    notes="vocab padded 256206->256256; frontend stubbed with frame embeddings",
)
