"""Model factory: ModelConfig -> model implementing the serving API.

Copied from ``src/repro/models/zoo.py``.  API (all models):
  param_defs() / init(generator) / load(params) / params
  loss(params, batch) -> (loss, metrics)   (the dense family; Mamba2 and
      Zamba2 raise until the SSD scan has a backward kernel)
  prefill(params, tokens, max_len) -> (cache, logits)
  decode_step(params, cache, token, pos) -> (logits, cache)
  cache_struct(batch, max_len) / init_cache(batch, max_len)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2LM


def get_model(cfg: ModelConfig):
    if cfg.family == "dense":
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg)
    if cfg.family in ("moe", "vlm", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet; see ROADMAP.md")
    raise ValueError(f"unknown family {cfg.family!r}")
