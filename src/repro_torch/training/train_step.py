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
shards.  A masked batch over several batch shards weighs each local
microbatch so that the sum over the ranks is JAX's masked mean per
microbatch of the global batch (``make_grad_fn``).  Gradient
compression under a plan runs where JAX's does, on
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
                      accum_dtype=torch.float32, weigh=None):
    """Mean grads over ``n_micro`` sequential microbatches of the batch's
    leading axis (every entry of the batch, ``enc_emb`` too), summed in
    ``accum_dtype``.  ``weigh(i, loss, metrics)``, where given, is what
    microbatch i contributes in place of its loss (the masked sharded
    step's weights).  Returns (grads, loss, metrics); metrics are the
    loss function's for one microbatch, {} for several, as in JAX."""
    def piece(i):
        if weigh is None:
            return loss_fn

        def weighed(p, b):
            loss, metrics = loss_fn(p, b)
            return weigh(i, loss, metrics), metrics
        return weighed

    if n_micro == 1:
        loss, metrics, grads = _value_and_grad(piece(0), params, batch)
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
        loss, _, g = _value_and_grad(piece(i), params,
                                     {k: v[sl] for k, v in batch.items()})
        tree_map(lambda a, b: a.add_(b.to(a.dtype)), acc, g)
        del g
        loss_sum = loss if loss_sum is None else loss_sum + loss
    # in place: the same quotients as a new tree, without a second copy
    tree_map(lambda a: a.div_(n_micro), acc)
    return acc, loss_sum / n_micro, {}


def _masked_weigh(mask, n_micro: int, k: int, mesh, batch_axes):
    """``_microbatch_grads``' ``weigh`` for this rank's rows of a masked
    global batch cut over ``batch_axes`` (n shards of R rows), taken as
    ``k`` local microbatches ("pieces") where JAX takes ``n_micro``
    microbatches of the global batch.  JAX's loss is

        L = (1/m) sum_i (S_i / max(C_i, 1) + A_i)

    (m = n_micro; S_i, C_i the masked NLL sum and the mask's sum over
    global microbatch i, A_i its rows' mean aux loss).  Each piece lies
    inside one global microbatch i(j) (m divides B, k divides R: the
    pieces are aligned on their size), so with s_j = ce_j max(c_j, 1)
    the piece's NLL sum and every piece the same number of rows,

        L = sum over ranks and pieces of
            s_j / (m max(C_i(j), 1)) + aux_j / (n k).

    The step averages a rank's pieces (1/k) and ``reduce_grads`` and the
    loss's mean over the batch shards divide by n, so piece j
    contributes n k s_j / (m max(C_i(j), 1)) + aux_j: the aux term as
    unmasked, the NLL by the global count of its microbatch (one
    all-reduce of m floats: ``parallel.global_token_counts``)."""
    counts = par.global_token_counts(mask, n_micro, mesh, batch_axes)
    R = mask.shape[0]
    n = math.prod(mesh.shape[a] for a in par.entry_axes(batch_axes))
    first = par.block_offsets((R,), (batch_axes,), mesh)[0]
    micro = [(first + j * (R // k)) // (R * n // n_micro) for j in range(k)]
    scale = (n * k / n_micro) / torch.clamp(
        counts[torch.tensor(micro, device=counts.device)], min=1.0)

    def weigh(j, loss, metrics):
        return (scale[j] * metrics["ce"] * torch.clamp(metrics["tokens"],
                                                       min=1.0)
                + metrics["aux"])
    return weigh


def make_grad_fn(model, cfg: ModelConfig, plan):
    """(params, batch) -> (grads, loss) of a sharded step: this rank's
    shards of the parameters and its rows in, this rank's shards of the
    gradient and the loss of the global batch out: unmasked, the means
    over the batch shards; with a ``"mask"`` over several batch shards,
    JAX's masked mean per microbatch of the global batch
    (``_masked_weigh``).  The gradient is taken with respect to the
    shards themselves: the model gathers them unit by unit as it runs."""
    mesh, specs = plan.mesh, model.param_specs()
    partial = model.model_partial_leaves()
    batch_axes = par.entry_axes(plan.batch_axes)
    n = math.prod(mesh.shape[a] for a in batch_axes)

    def grad_fn(params, batch):
        # the config's microbatches are a cap: a rank holding fewer rows
        # (a wide mesh's batch shards) runs one row a microbatch, whose
        # mean gradient is the same
        rows = next(iter(batch.values())).shape[0]
        k = min(cfg.grad_accum_microbatches, rows)
        weigh = None
        if n > 1 and "mask" in batch:
            weigh = _masked_weigh(batch["mask"], cfg.grad_accum_microbatches,
                                  k, mesh, batch_axes)
        grads, loss, _ = _microbatch_grads(
            model.loss, params, batch, k,
            getattr(torch, cfg.grad_accum_dtype), weigh)
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


def make_eval_step(model, plan=None):
    """(params, batch) -> {loss, ce, aux, tokens} of ``model.loss``
    without a gradient.  With ``plan``, of the global batch as JAX's
    eval step gives it, from this rank's shards and rows: the masked NLL
    sums and token counts summed over the batch axes (one all-reduce),
    ce their quotient, aux the mean over the batch shards (a mean over
    rows, every shard the same number)."""
    n, mesh, batch_axes = 1, None, ()
    if plan is not None:
        mesh, batch_axes = plan.mesh, par.entry_axes(plan.batch_axes)
        n = math.prod(mesh.shape[a] for a in batch_axes)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
            if n > 1:
                ce, aux, cnt = (metrics[k] for k in ("ce", "aux", "tokens"))
                tot = torch.stack([ce * torch.clamp(cnt, min=1.0), cnt,
                                   aux.float()])
                par.all_reduce_(tot, mesh, batch_axes)
                ce = tot[0] / torch.clamp(tot[1], min=1.0)
                metrics = {"ce": ce, "aux": tot[2] / n, "tokens": tot[1]}
                loss = ce + metrics["aux"]
        return {"loss": loss, **metrics}
    return eval_step
