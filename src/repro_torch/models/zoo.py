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
plan ``make_plan`` gives but those ``check_plan`` raises for; the
serving narrowings raise where they are met (``serving/engine.py``
under batch axes, a cache length its sequence axes do not divide).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2LM


def check_plan(cfg: ModelConfig, plan) -> None:
    """Raise ``NotImplementedError`` for a plan the port cannot run under
    a "model" axis of more than one process: MoE experts that do not
    divide the axis (JAX then cuts each expert's d_ff_expert,
    "mlp_exp"), the SSM's d_in and heads split differently
    (``ssm_inner`` and ``ssm_head`` disagree), or a sequence-sharded
    residual stream (``resid_seq``) through mamba layers whose heads the
    axis does not split.  Each holds for training and serving alike.
    Nothing silently runs unsharded."""
    if plan is None or plan.model_size == 1:
        return
    why = None
    if cfg.moe is not None and plan.rules["expert"] is None:
        why = (f"{cfg.moe.n_experts} experts that do not divide the axis "
               f"(each expert's d_ff_expert cut)")
    if cfg.ssm is not None:
        inner, head = plan.rules["ssm_inner"], plan.rules["ssm_head"]
        if inner != head:
            why = (f'rules["ssm_inner"] = {inner!r} and '
                   f'rules["ssm_head"] = {head!r} disagree')
        elif plan.resid_seq is not None and head is None:
            why = ("a sequence-sharded residual stream (resid_seq) "
                   "through mamba layers whose heads the axis does not "
                   "split")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {why} under a model axis of {plan.model_size}; "
            f"not ported (ROADMAP.md item 8)")


def get_model(cfg: ModelConfig, plan=None):
    check_plan(cfg, plan)
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, plan)
    if cfg.family == "ssm":
        return Mamba2LM(cfg, plan)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, plan)
    if cfg.family == "encdec":
        return EncDecLM(cfg, plan)
    raise ValueError(f"unknown family {cfg.family!r}")
