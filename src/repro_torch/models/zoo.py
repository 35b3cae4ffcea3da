"""Model factory: ModelConfig (+ sharding plan) -> model.

Copied from ``src/repro/models/zoo.py`` (``get_model`` ``:22``).  API
(all models):
  param_defs() / init(generator) / load(params) / params / param_specs()
  loss(params, batch) -> (loss, metrics)   (encdec: batch also holds
      ``enc_emb`` (B, Se, D))
  prefill(params, inputs, max_len) -> (cache, logits)   (inputs: token
      ids (B, S), or frame embeddings (B, Se, D) for encdec)
  decode_step(params, cache, token, pos) -> (logits, cache)
  cache_struct(batch, max_len) / init_cache(batch, max_len)

A plan whose "model" axis has more than one process splits every
family's work over it, as the JAX models' sharding constraints lay it
out (``distributed/parallel.py`` ``TensorParallel``): attention heads
(or query rows where the heads do not divide the axis: sequence
parallelism), MLP columns, MoE experts, SSM heads, the vocabulary, and
with ``seq_shard_activations`` the residual stream's positions
(Megatron-SP).  Training and serving (``prefill`` / ``decode_step`` with
the caches of ``launch/programs.py`` ``cache_specs``) run under every
plan ``make_plan`` gives: MoE experts that do not divide the axis cut
each expert's d_ff_expert (``moe.py``), and mamba layers whose heads
the axis does not split run whole on every rank
(``mamba2.mamba_layer``).  The serving narrowings raise where they are
met (``serving/engine.py`` under batch axes, a cache length its
sequence axes do not divide).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2LM


def get_model(cfg: ModelConfig, plan=None):
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, plan)
    if cfg.family == "ssm":
        return Mamba2LM(cfg, plan)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, plan)
    if cfg.family == "encdec":
        return EncDecLM(cfg, plan)
    raise ValueError(f"unknown family {cfg.family!r}")
