"""train_step: microbatched gradient accumulation, optional int8 gradient
compression, and the optimizer, assembled for one model.

Copied from ``src/repro/training/train_step.py``.  The step is a plain
function (params, opt_state, batch, step) -> (params, opt_state,
metrics): the gradients come from ``torch.autograd.grad`` of the model's
loss, and the optimizer updates the parameters and its state in place
under ``torch.no_grad()`` (``training/optimizers.py``), so the returned
trees are the ones passed in.

With a plan (``distributed/rules.py``) over a process mesh, the trees
hold this rank's shards (``model.param_specs()``, ``optimizers
.state_specs``) and the batch this rank's rows, and a step does what the
JAX step's shardings make GSPMD do: the forward and backward run on the
local rows (microbatches split them) with the parameters still sharded,
the model gathering each unit's FSDP shards over the data axes where the
unit runs and again in its recompute, and reduce-scattering each unit's
gradient in the backward (``LMBase.layer``, ``parallel.gather_data``);
so the gradients, and the microbatches' accumulator, have the shards'
shapes.  Then ``parallel.reduce_grads`` finishes the mean over the batch
axes on the shards, the step clips by the global norm over the shards
and runs the optimizer on them.  The loss is the mean over the batch
shards.  Gradient compression under a plan runs where JAX's does, on
the mean gradient before the optimizer: ``compression.compress_sharded``
gives each rank its block of the whole leaf's int8 round trip, bit for
bit, the block maxima all-reduced over the axes that cut the leaf.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as par
from repro_torch.distributed.compression import (compress_decompress,
                                                 compress_sharded)
from repro_torch.training import optimizers as opt
from repro_torch.utils.params import tree_from_flat, tree_leaves, tree_map


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``; grads is a
    nested dict shaped like params.  Every parameter is set to require
    grad."""
    leaves = tree_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
    flat = {name: g for (name, _), g in zip(leaves, grads)}
    return loss.detach(), metrics, tree_from_flat(params, flat)


def _microbatch_grads(loss_fn, params, batch, n_micro: int,
                      accum_dtype=torch.float32):
    """Mean grads over ``n_micro`` sequential microbatches of the batch's
    leading axis (every entry of the batch, ``enc_emb`` too), summed in
    ``accum_dtype``.  Returns (grads, loss,
    metrics); metrics are the loss function's for one microbatch, {} for
    several, as in JAX."""
    if n_micro == 1:
        loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        return grads, loss, metrics
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
    loss_sum = None
    for i in range(n_micro):
        sl = slice(i * (B // n_micro), (i + 1) * (B // n_micro))
        loss, _, g = _value_and_grad(loss_fn, params,
                                     {k: v[sl] for k, v in batch.items()})
        tree_map(lambda a, b: a.add_(b.to(a.dtype)), acc, g)
        del g
        loss_sum = loss if loss_sum is None else loss_sum + loss
    # in place: the same quotients as a new tree, without a second copy
    tree_map(lambda a: a.div_(n_micro), acc)
    return acc, loss_sum / n_micro, {}


def make_grad_fn(model, cfg: ModelConfig, plan):
    """(params, batch) -> (grads, loss) of a sharded step: this rank's
    shards of the parameters and its rows in, this rank's shards of the
    mean gradient over the batch shards and that mean loss out.  The
    gradient is taken with respect to the shards themselves: the model
    gathers them unit by unit as it runs."""
    mesh, specs = plan.mesh, model.param_specs()
    partial = model.model_partial_leaves()
    batch_axes = par.entry_axes(plan.batch_axes)
    n = math.prod(mesh.shape[a] for a in batch_axes)

    def grad_fn(params, batch):
        if n > 1 and "mask" in batch:
            raise NotImplementedError(
                "a masked batch over several batch shards: each rank's "
                "mean loss would weigh its own token count; JAX takes a "
                "masked mean per microbatch of the global batch "
                "(ROADMAP.md §3, contract narrowings)")
        # the config's microbatches are a cap: a rank holding fewer rows
        # (a wide mesh's batch shards) runs one row a microbatch, whose
        # mean gradient is the same
        rows = next(iter(batch.values())).shape[0]
        grads, loss, _ = _microbatch_grads(
            model.loss, params, batch,
            min(cfg.grad_accum_microbatches, rows),
            getattr(torch, cfg.grad_accum_dtype))
        grads = par.reduce_grads(grads, specs, mesh, batch_axes, partial)
        if n > 1:
            loss = par.all_reduce_(loss.clone(), mesh, batch_axes) / n
        return grads, loss

    return grad_fn


def make_train_step(model, cfg: ModelConfig, plan=None, opt_name: str = None,
                    grad_compression: bool = False,
                    opt_cfg: opt.OptConfig = None):
    """(train_step, opt_init, opt config) for ``model`` (its ``loss``) and
    ``cfg`` (optimizer, microbatches, accumulation dtype); with ``plan``,
    the sharded step over its process mesh."""
    opt_name = opt_name or cfg.optimizer
    if plan is not None:
        specs = model.param_specs()
        ocfg, opt_init, opt_update = opt.make_optimizer(
            opt_name, opt_cfg, plan.mesh, specs)
        grad_fn = make_grad_fn(model, cfg, plan)

        def sharded_step(params, opt_state, batch, step):
            grads, loss = grad_fn(params, batch)
            if grad_compression:
                grads = compress_sharded(grads, specs, plan.mesh)
            params, opt_state, om = opt_update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, **om, "step": step + 1}

        return sharded_step, opt_init, ocfg
    ocfg, opt_init, opt_update = opt.make_optimizer(opt_name, opt_cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch)

    def train_step(params, opt_state, batch, step):
        grads, loss, _ = _microbatch_grads(
            loss_fn, params, batch, cfg.grad_accum_microbatches,
            getattr(torch, cfg.grad_accum_dtype))
        if grad_compression:
            grads = tree_map(compress_decompress, grads)
        params, opt_state, om = opt_update(grads, opt_state, params)
        metrics = {"loss": loss, **om, "step": step + 1}
        return params, opt_state, metrics

    return train_step, opt_init, ocfg


def make_eval_step(model):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
