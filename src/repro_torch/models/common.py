"""Shared model pieces: norms, rope, embeddings, MLP, and the base of
the port's language models.

Copied from ``src/repro/models/common.py``: forward only (the training
pieces, ``chunked_xent`` and the hand-written VJPs, are not ported).
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.params import (ParamDef, init_params, is_node,
                                      to_parameter_dict, with_dtype)

NEG_INF = -1e30

CacheSpec = collections.namedtuple("CacheSpec", ["shape", "dtype"])


def rms_norm(x, scale, eps: float):
    """x * rsqrt(mean(x^2) + eps) * scale: the mean of squares in f32,
    the products in x's dtype."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None]
    return x * inv.to(x.dtype) * scale.to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, d) with d even; positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = positions.to(torch.float32)[..., None, None] * freq  # (...,S,1,d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ embedding
def embed_defs(cfg: ModelConfig):
    d = {"table": ParamDef((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), "normal")}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"), "scaled")
    return d


def embed(p, tokens, cfg: ModelConfig):
    return p["table"][tokens].to(cfg.act_dtype)


def unembed_matrix(p, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return p["table"].T
    return p["unembed"]


def logits_last(p, h_last, cfg: ModelConfig):
    """h_last: (B, D) -> (B, Vp) f32 logits with padded vocab masked."""
    w = unembed_matrix(p, cfg)
    logits = h_last.float() @ w.float()
    if cfg.vocab_padded != cfg.vocab_size:
        logits[:, cfg.vocab_size:] = NEG_INF
    return logits


# ----------------------------------------------------------------------- MLP
def mlp_defs(cfg: ModelConfig, d_ff: int = 0):
    f = d_ff or cfg.d_ff
    D = cfg.d_model
    return {
        "w_gate": ParamDef((D, f), ("embed", "mlp"), "scaled"),
        "w_up": ParamDef((D, f), ("embed", "mlp"), "scaled"),
        "w_down": ParamDef((f, D), ("mlp", "embed"), "scaled"),
    }


def mlp(p, x):
    h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def norm_defs(cfg: ModelConfig):
    return {"scale": ParamDef((cfg.d_model,), (None,), "ones")}


# ------------------------------------------------------------ model plumbing
def layer_slice(tree, i):
    """Layer ``i`` of a tree of stacked parameters: each leaf indexed on
    its leading axis (a view, no copy)."""
    if is_node(tree):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


class LMBase(nn.Module):
    """What the port's language models share: their parameters live in
    ``self.params``, a nested ``nn.ParameterDict`` in the JAX pytree's
    layout (same keys, same stacked leading axes), and their cache
    tensors are made from ``cache_struct``.  ``prefill`` and
    ``decode_step`` take the parameters as their first argument, as the
    JAX models do."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.params = None

    def param_defs(self):
        return with_dtype(self._param_defs_raw(), self.cfg.param_dtype)

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device."""
        return self.load(init_params(self.param_defs(), generator))

    def load(self, params):
        """Hold ``params`` (a nested mapping of tensors in the layout of
        ``param_defs``) as this model's parameters; returns them."""
        self.params = (params if isinstance(params, nn.ParameterDict)
                       else to_parameter_dict(params))
        return self.params

    @property
    def device(self) -> torch.device:
        if self.params is None:
            return torch.device("cpu")
        return next(self.params.parameters()).device

    def init_cache(self, batch: int, max_len: int):
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_struct(batch, max_len).items()}
