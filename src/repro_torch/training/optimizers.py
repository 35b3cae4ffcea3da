"""Optimizers: AdamW and Adafactor over nested dicts of tensors.

Copied from ``src/repro/training/optimizers.py`` (``state_specs``
``:141``).  The arithmetic is the JAX code's, op for op in f32.  Where
JAX returns new trees, the port updates in place, under
``torch.no_grad()``: the parameters (``Parameter.copy_``), the moment
tensors and the clipped gradients, so a step holds no second copy of
any; each update function returns the same trees it was given, with a
new ``step`` tensor.
Adafactor keeps factored second moments (row / column) for >= 2-D
parameters whose last two dims are both >= ``min_dim_factored``.

On a mesh (``mesh`` and the parameters' ``specs``) every tree holds this
rank's shards, and the state is laid out as ``state_specs`` says (ZeRO:
each moment cut like its parameter).  AdamW is elementwise and runs on
the shards as it is.  What spans a leaf sums over the axes that cut it:
the global norm's sum of squares per leaf (a replicated leaf counts
once), Adafactor's means over a cut dim (``vr``, ``vc``, the row
normaliser) and its update-RMS clip; its factored-or-not choice reads
the full shape.  Without a mesh every op is the one-card one.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import parallel as par
from repro_torch.utils.params import PartitionSpec as P
from repro_torch.utils.params import tree_from_flat, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # adafactor
    min_dim_factored: int = 128
    decay_exponent: float = 0.8


def schedule(cfg: OptConfig, step):
    """Linear warm-up: lr * min(1, (step + 1) / warmup), f32; ``step`` an
    integer tensor."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm.float()


def _spec_of(specs):
    """name -> spec of a tree of specs (every leaf replicated without)."""
    return dict(tree_leaves(specs)) if specs is not None else {}


def global_norm(tree, mesh=None, specs=None):
    """sqrt of the sum of squares of every leaf, in f32; on a mesh each
    leaf's sum over the axes that cut it, the leaves summed in order."""
    sp = _spec_of(specs)

    def sq(name, x):
        s = torch.sum(torch.square(x.float()))
        if mesh is not None:
            par.all_reduce_(s, mesh, par.spec_axes(sp[name], mesh))
        return s
    return torch.sqrt(sum(sq(n, x) for n, x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm, mesh=None, specs=None):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before).  Each leaf keeps its dtype and is scaled in place (the
    JAX code's products, without a second copy of every gradient)."""
    g = global_norm(grads, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: x.mul_(scale.to(x.dtype)), grads), g


def _pairs(grads, *trees):
    """Leaves of ``grads`` and the matching leaves of ``trees``, by key."""
    flat = [dict(tree_leaves(t)) for t in trees]
    return [(g,) + tuple(f[name] for f in flat)
            for name, g in tree_leaves(grads)]


# ------------------------------------------------------------------- adamw
def adamw_init(params):
    dev = tree_leaves(params)[0][1].device
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params, mesh=None,
                 specs=None):
    """One AdamW step, in place (``grads`` are clipped in place too);
    returns (params, state, {grad_norm, lr})."""
    step = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, mesh, specs)
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(torch.tensor(b1, device=step.device), step.float())
    c2 = 1 - torch.pow(torch.tensor(b2, device=step.device), step.float())
    for g, m, v, p in _pairs(grads, state["m"], state["v"], params):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------- adafactor
def _factored(shape, min_dim):
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(cfg: OptConfig, params, mesh=None, specs=None):
    dev = tree_leaves(params)[0][1].device
    sp = _spec_of(specs)

    def per(name, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        full = (p.shape if mesh is None
                else par.global_shape(p.shape, sp[name], mesh))
        if _factored(full, cfg.min_dim_factored):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    return {"f": tree_from_flat(params, {n: per(n, p) for n, p in
                                         tree_leaves(params)}),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params, mesh=None,
                     specs=None):
    """One Adafactor step, in place (``grads`` are clipped in place too);
    returns (params, state, {grad_norm, lr})."""
    step = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, mesh, specs)
    lr = schedule(cfg, state["step"])
    beta = 1.0 - step.float() ** (-cfg.decay_exponent)
    flat_p = dict(tree_leaves(params))
    sp = _spec_of(specs)
    for name, g in tree_leaves(grads):
        s = state["f"]
        for key in name.split("."):
            s = s[key]
        p = flat_p[name]
        cuts = (par.dim_axes(sp[name], p.ndim) if mesh is not None
                else [()] * p.ndim)
        g = g.float()
        g2 = g * g + 1e-30
        if "vr" in s:
            s["vr"].copy_(beta * s["vr"]
                          + (1 - beta) * par.mean_over(g2, -1, mesh, cuts[-1]))
            s["vc"].copy_(beta * s["vc"]
                          + (1 - beta) * par.mean_over(g2, -2, mesh, cuts[-2]))
            vr, vc = s["vr"], s["vc"]
            r = vr / torch.clamp(par.mean_over(vr, -1, mesh, cuts[-2], True),
                                 min=1e-30)
            pre = torch.sqrt(r[..., None] * vc[..., None, :])
            u = g / torch.clamp(pre, min=1e-30)
        else:
            s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            u = g / torch.sqrt(s["v"] + 1e-30)
        # update clipping (RMS <= 1) per Shazeer & Stern
        live = () if mesh is None else par.spec_axes(sp[name], mesh)
        if live:
            ms = par.all_reduce_(torch.sum(u * u), mesh, live) / math.prod(
                par.global_shape(p.shape, sp[name], mesh))
        else:
            ms = torch.mean(u * u)
        rms = torch.sqrt(ms + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------- factory
def make_optimizer(name: str, cfg: OptConfig = None, mesh=None, specs=None):
    """(config, init(params), update(grads, state, params)); on a mesh
    the trees are this rank's shards of the parameters' ``specs``."""
    cfg = cfg or OptConfig(name=name)
    if name == "adamw":
        return cfg, adamw_init, \
            lambda g, s, p: adamw_update(cfg, g, s, p, mesh, specs)
    if name == "adafactor":
        return cfg, lambda p: adafactor_init(cfg, p, mesh, specs), \
            lambda g, s, p: adafactor_update(cfg, g, s, p, mesh, specs)
    raise ValueError(name)


def state_specs(name: str, cfg: OptConfig, param_specs, params):
    """PartitionSpecs for the optimizer state, mirroring the parameters'
    (``params``: full-shaped leaves, anything with a ``shape``)."""
    if name == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}
    shapes = dict(tree_leaves(params))

    def per(n, spec):
        shape = tuple(shapes[n].shape)
        t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        if _factored(shape, cfg.min_dim_factored):
            return {"vr": P(*t[:-1]), "vc": P(*(t[:-2] + t[-1:]))}
        return {"v": spec}

    f = tree_from_flat(param_specs, {n: per(n, s) for n, s in
                                     tree_leaves(param_specs)})
    return {"f": f, "step": P()}
