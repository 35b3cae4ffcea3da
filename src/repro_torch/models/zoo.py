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

A plan with a "model" axis of one process is taken by every family: data
parallelism and FSDP wrap the forward (``training/train_step.py``) and
leave it as it is.  Tensor parallelism over a larger "model" axis is
ported for the dense transformer (the dense and vlm families) alone.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2LM


def check_plan(cfg: ModelConfig, plan) -> None:
    """Raise ``NotImplementedError`` for a plan the port cannot run: a
    "model" axis of more than one process for the moe, ssm, hybrid and
    encdec families, or with sequence parallelism (``seq_axes``: heads
    that do not divide the axis) or a sequence-sharded residual stream
    (``resid_seq``).  Nothing silently runs unsharded."""
    if plan is None or plan.model_size == 1:
        return
    why = None
    if cfg.family not in ("dense", "vlm"):
        why = f"the {cfg.family} family"
    elif plan.seq_axes is not None:
        why = (f"sequence parallelism ({cfg.n_heads} heads on a "
               f"{plan.model_size}-way model axis)")
    elif plan.resid_seq is not None:
        why = "a sequence-sharded residual stream (resid_seq)"
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {why} under a model axis of {plan.model_size} is "
            f"not ported (ROADMAP.md item 8); use a model axis of 1")


def get_model(cfg: ModelConfig, plan=None):
    check_plan(cfg, plan)
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, plan)
    if cfg.family == "ssm":
        model = Mamba2LM(cfg)
    elif cfg.family == "hybrid":
        model = Zamba2LM(cfg)
    elif cfg.family == "encdec":
        model = EncDecLM(cfg)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    model.plan = plan
    return model
