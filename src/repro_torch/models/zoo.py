"""Model factory: ModelConfig -> model implementing the common API.

Copied from ``src/repro/models/zoo.py``.  API (all models):
  param_defs() / init(generator) / load(params) / params
  loss(params, batch) -> (loss, metrics)   (encdec: batch also holds
      ``enc_emb`` (B, Se, D))
  prefill(params, inputs, max_len) -> (cache, logits)   (inputs: token
      ids (B, S), or frame embeddings (B, Se, D) for encdec)
  decode_step(params, cache, token, pos) -> (logits, cache)
  cache_struct(batch, max_len) / init_cache(batch, max_len)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2LM


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
