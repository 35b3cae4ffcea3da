"""Model configurations: one frozen dataclass per architecture and the
run-shape table.

Copied from ``src/repro/configs/base.py``; ``act_dtype`` returns a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1          # MoE block every `every` layers (1 = all layers)
    shared_expert_ff: int = 0  # >0 adds an always-on shared expert (llama4)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid (zamba2): one shared transformer block applied every k layers
    shared_attn_every: int = 0
    # encdec (seamless): layers are split enc/dec; n_layers == enc + dec
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub: inputs are precomputed frame/patch embeddings
    embed_inputs: bool = False
    # numerics / execution
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"               # full | dots | none
    scan_layers: bool = True
    attn_impl: str = "blocked"        # xla | blocked | pallas
    scan_block: int = 0               # >0: two-level layer scan (sqrt-remat)
    seq_shard_activations: bool = False  # Megatron-SP residual stream
    cache_update: str = "dus"         # dus | onehot (decode cache write)
    attn_chunk: int = 1024            # kv chunk for blocked attention
    logit_chunk: int = 1024           # seq chunk for chunked xent
    optimizer: str = "adamw"          # adamw | adafactor
    grad_accum_microbatches: int = 1  # for train_4k at production scale
    grad_accum_dtype: str = "float32"  # bf16 halves the accum buffer
    notes: str = ""

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# archs with an O(S^2)-only attention path skip long_500k (see DESIGN.md §6)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def supports_shape(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "full-attention arch: O(S^2) at 524k tokens (skip per assignment)"
    return True, ""

def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, min(cfg.n_layers, 2)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        grad_accum_microbatches=1,
        attn_chunk=32,
        logit_chunk=32,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            shared_expert_ff=64 if cfg.moe.shared_expert_ff else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
        kw["d_model"] = 64
    if cfg.enc_layers:
        kw["enc_layers"] = 2
        kw["dec_layers"] = 2
        kw["n_layers"] = 4
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
        kw["n_layers"] = 4
    return cfg.replace(**kw)
