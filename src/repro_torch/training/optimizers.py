"""Optimizers: AdamW and Adafactor over nested dicts of tensors.

Copied from ``src/repro/training/optimizers.py`` without ``state_specs``
(sharding; ROADMAP.md item 8).  The arithmetic is the JAX code's, op for
op in f32.  Where JAX returns new trees, the port updates in place, under
``torch.no_grad()``: the parameters (``Parameter.copy_``), the moment
tensors and the clipped gradients, so a step holds no second copy of
any; each update function returns the same trees it was given, with a
new ``step`` tensor.
Adafactor keeps factored second moments (row / column) for >= 2-D
parameters whose last two dims are both >= ``min_dim_factored``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.params import tree_leaves, tree_map


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


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before).  Each leaf keeps its dtype and is scaled in place (the
    JAX code's products, without a second copy of every gradient)."""
    g = global_norm(grads)
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
def adamw_update(cfg: OptConfig, grads, state, params):
    """One AdamW step, in place (``grads`` are clipped in place too);
    returns (params, state, {grad_norm, lr})."""
    step = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
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


def adafactor_init(cfg: OptConfig, params):
    dev = tree_leaves(params)[0][1].device

    def per(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape, cfg.min_dim_factored):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    return {"f": tree_map(per, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    """One Adafactor step, in place (``grads`` are clipped in place too);
    returns (params, state, {grad_norm, lr})."""
    step = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = schedule(cfg, state["step"])
    beta = 1.0 - step.float() ** (-cfg.decay_exponent)
    flat_p = dict(tree_leaves(params))
    for name, g in tree_leaves(grads):
        s = state["f"]
        for key in name.split("."):
            s = s[key]
        p = flat_p[name]
        g = g.float()
        g2 = g * g + 1e-30
        if "vr" in s:
            s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
            s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
            vr, vc = s["vr"], s["vc"]
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            pre = torch.sqrt(r[..., None] * vc[..., None, :])
            u = g / torch.clamp(pre, min=1e-30)
        else:
            s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            u = g / torch.sqrt(s["v"] + 1e-30)
        # update clipping (RMS <= 1) per Shazeer & Stern
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ----------------------------------------------------------------- factory
def make_optimizer(name: str, cfg: OptConfig = None):
    """(config, init(params), update(grads, state, params))."""
    cfg = cfg or OptConfig(name=name)
    if name == "adamw":
        return cfg, adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p)
    if name == "adafactor":
        return cfg, lambda p: adafactor_init(cfg, p), \
            lambda g, s, p: adafactor_update(cfg, g, s, p)
    raise ValueError(name)
