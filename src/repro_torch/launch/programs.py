"""The (fn, kwargs, donate, meta) of every (arch x shape x mesh) cell,
the layouts of a model's inputs and caches under a sharding plan, and
the shapes a rank holds of them.

Counterpart of ``src/repro/launch/programs.py``.  ``batch_specs`` and
``cache_specs`` are copied from it (``:35-74``), with the port's
``PartitionSpec``: ``batch_specs`` gives the specs alone (JAX attaches
them to abstract arrays).  ``build_cell`` (JAX ``:77``) gives the cell's
step and this rank's inputs as meta tensors: JAX's are abstract arrays
with shardings, the port's are each rank's blocks, which
``launch/dryrun.py`` runs over a fake process group.  JAX's
``lower_cell`` lowers the cell to HLO; torch has no HLO, and it has no
counterpart.  ``local_cache_struct`` gives each cache leaf's shape as
this rank holds it: its ``parallel.block`` of the global shape under
``cache_specs``; a dim the spec's axes do not divide raises, as it does
for parameters.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg, smoke_config
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.distributed import parallel as par
from repro_torch.distributed.rules import ShardingPlan, make_plan
from repro_torch.models.common import CacheSpec
from repro_torch.training import optimizers as opt
from repro_torch.utils.params import PartitionSpec as P
from repro_torch.utils.params import tree_leaves, tree_map


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


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _local_tree(tree, specs, mesh):
    """Meta tensors of this rank's blocks of ``tree``'s leaves (anything
    with ``shape`` and ``dtype``) under ``specs`` (every leaf whole
    without a mesh)."""
    if mesh is None:
        return tree_map(lambda x: _meta(x.shape, x.dtype), tree)
    return tree_map(lambda x, sp: _meta(local_shape(x.shape, sp, mesh),
                                        x.dtype), tree, specs)


def build_cell(arch: str, shape_name: Union[str, ShapeCfg], mesh,
               overrides: Optional[dict] = None, smoke: bool = False):
    """Returns (fn, kwargs, donate_argnames, meta) as JAX's does: ``fn(**
    kwargs)`` runs the cell's program once on this rank of ``mesh`` (a
    ``ProcessMesh`` over the world, every rank making the same calls;
    None: one device, no plan), and ``kwargs`` are meta tensors of this
    rank's blocks:
    - train: the parameters under ``make_specs``, the optimizer state
      under ``optimizers.state_specs``, the batch under ``batch_specs``
      and the step; ``fn`` is ``make_train_step``'s step;
    - prefill: the parameters and the inputs (token ids, or encdec's
      frame embeddings in bf16, as JAX's); ``fn`` is ``model.prefill``;
    - decode: the parameters, the cache (``local_cache_struct``), one
      token a row and ``pos`` (a Python int: S - 1, the cache's last
      position); ``fn`` is one ``model.decode_step``.
    A serving rank holds its model-local leaves (the FSDP cut gathered,
    ``LMBase.load_serving``), as the port serves.  ``shape_name`` may be
    a ``ShapeCfg``; ``smoke`` takes the arch's smoke config (tests)."""
    from repro_torch.models.zoo import get_model
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = (get_shape(shape_name) if isinstance(shape_name, str)
             else shape_name)
    plan = None if mesh is None else make_plan(cfg, mesh, shape)
    model = get_model(cfg, plan)
    defs = model.param_defs()
    p_specs = None if plan is None else model.param_specs()
    meta = {"arch": arch, "shape": shape.name, "cfg": cfg, "plan": plan,
            "model": model, "param_specs": p_specs}
    B, S = shape.global_batch, shape.seq_len
    rows = B // model.batch_shards

    if shape.kind == "train":
        params = _local_tree(defs, p_specs, mesh)
        train_step, opt_init, ocfg = make_train_step(model, cfg, plan)
        # the state's global shapes (meta, no data), then this rank's
        # blocks of them under state_specs
        o_full = opt.make_optimizer(cfg.optimizer, ocfg)[1](
            _local_tree(defs, None, None))
        o_specs = (None if plan is None else opt.state_specs(
            cfg.optimizer, ocfg, p_specs, defs))
        o_state = _local_tree(o_full, o_specs, mesh)
        b_specs = None if plan is None else batch_specs(cfg, shape, plan)
        batch = {"tokens": (B, S, torch.int32), "labels": (B, S, torch.int32)}
        if cfg.family == "encdec":
            batch["enc_emb"] = (B, S, cfg.d_model, torch.bfloat16)
        batch = {k: _meta(v[:-1], v[-1]) for k, v in batch.items()}
        kwargs = {"params": params, "opt_state": o_state,
                  "batch": _local_tree(batch, b_specs, mesh),
                  "step": _meta((), torch.int32)}

        def fn(params, opt_state, batch, step):
            return train_step(params, opt_state, batch, step)

        return fn, kwargs, ("params", "opt_state"), meta

    # serving: this rank's model-local leaves (the data axes' cut gathered)
    params = model.load_local(_local_tree(
        defs, None if plan is None else model.serve_specs(), mesh))
    if shape.kind == "prefill":
        inp = (_meta((rows, S, cfg.d_model), torch.bfloat16)
               if cfg.family == "encdec" else _meta((rows, S), torch.int32))
        kwargs = {"params": params, "inputs": inp}

        def fn(params, inputs):
            with torch.no_grad():
                return model.prefill(params, inputs, S)

        return fn, kwargs, (), meta

    cache = {k: _meta(c.shape, c.dtype)
             for k, c in model.local_cache_struct(B, S).items()}
    kwargs = {"params": params, "cache": cache,
              "token": _meta((rows,), torch.int32), "pos": S - 1}

    def fn(params, cache, token, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, token, pos)

    return fn, kwargs, ("cache",), meta


def argument_bytes(kwargs) -> int:
    """The bytes of a cell's arguments (``memory_analysis``'s
    ``argument_size_in_bytes``): every tensor's, and 4 for an int (JAX
    passes ``pos`` as an int32 scalar)."""
    total = 0
    for v in kwargs.values():
        if isinstance(v, int):
            total += 4
        else:
            total += sum(x.numel() * x.element_size()
                         for _, x in tree_leaves(v))
    return total
