"""The layouts of a served model's inputs and caches under a sharding
plan, and the shapes a rank holds of them.

``batch_specs`` and ``cache_specs`` are copied from
``src/repro/launch/programs.py`` (``:35-74``), with the port's
``PartitionSpec``: ``batch_specs`` gives the specs alone (JAX attaches
them to abstract arrays).  JAX's ``build_cell`` / ``lower_cell`` lower a
cell to HLO and have no counterpart (ROADMAP.md "Not planned").
``local_cache_struct`` gives each cache leaf's shape as this rank holds
it: its ``parallel.block`` of the global shape under ``cache_specs``;
a dim the spec's axes do not divide raises, as it does for parameters.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.distributed import parallel as par
from repro_torch.distributed.rules import ShardingPlan
from repro_torch.models.common import CacheSpec
from repro_torch.utils.params import PartitionSpec as P


def batch_specs(cfg: ModelConfig, shape: ShapeCfg, plan: ShardingPlan):
    """The specs of a training or prefill batch: tokens and labels
    (B, S), and the encdec family's frame embeddings (B, S, D)."""
    tok = P(plan.batch_axes, None)
    out = {"tokens": tok, "labels": tok}
    if cfg.family == "encdec":
        out["enc_emb"] = P(plan.batch_axes, None, None)
    return out


def cache_specs(model, cfg: ModelConfig, plan: ShardingPlan):
    """PartitionSpec tree mirroring ``model.cache_struct``'s output."""
    cs = plan.cache_spec()  # (L,B,S,K,h)
    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": cs, "v": cs}
    if cfg.family in ("ssm", "hybrid"):
        inner = "model" if plan.rules.get("ssm_inner") else None
        head = "model" if plan.rules.get("ssm_head") else None
        out = {
            "conv_x": P(None, plan.cache_batch, None, inner),
            "conv_B": P(None, plan.cache_batch, None, None),
            "conv_C": P(None, plan.cache_batch, None, None),
            "state": P(None, plan.cache_batch, head, None, None),
        }
        if cfg.family == "hybrid":
            out.update(attn_k=cs, attn_v=cs)
        return out
    if cfg.family == "encdec":
        return {"k": cs, "v": cs, "xk": cs, "xv": cs}
    raise ValueError(cfg.family)


def local_shape(shape, spec, mesh) -> tuple:
    """This rank's block of a global ``shape`` cut by ``spec`` over the
    axes of size > 1 of ``mesh``; raises where they do not divide a
    dim."""
    out = []
    for d, (n, axes) in enumerate(zip(shape, par.dim_axes(spec,
                                                          len(shape)))):
        k = math.prod(mesh.shape[a] for a in axes)
        if n % k:
            raise ValueError(f"cache dim {d} of size {n} does not split "
                             f"over {axes} ({k} shards)")
        out.append(n // k)
    return tuple(out)


def local_cache_struct(model, plan: ShardingPlan, batch: int, max_len: int,
                       **kw):
    """``model.cache_struct(batch, max_len, **kw)`` (global shapes) with
    each leaf's shape this rank's block under ``cache_specs``."""
    specs = cache_specs(model, model.cfg, plan)
    return {k: CacheSpec(local_shape(s.shape, specs[k], plan.mesh), s.dtype)
            for k, s in model.cache_struct(batch, max_len, **kw).items()}
