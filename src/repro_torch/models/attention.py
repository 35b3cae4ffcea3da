"""GQA attention: the blocked (flash) prefill path, the single-step
decode path, optional qk-norm / qkv-bias, RoPE.

Copied from ``src/repro/models/attention.py``.  ``blocked_attention``
runs the flash kernel (``kernels.flash_attention``) on CUDA tensors and
its plain version on CPU tensors, and is differentiable: its gradient is
the backward kernel (or its plain version), the counterpart of the JAX
custom VJP ``_flash``.  ``decode_attention`` is plain torch ops, as in
the JAX package; over a cache cut on S (sharded serving) it combines
the ranks' partial softmaxes with two all-reduces, what GSPMD lowers
JAX's softmax over a sharded dim to.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as par
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import NEG_INF, rms_norm, rope
from repro_torch.utils.params import ParamDef


def attn_defs(cfg: ModelConfig):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("embed", "heads", "head_dim"), "scaled", fan_in_axes=(0,)),
        "wk": ParamDef((D, K, hd), ("embed", "kv_heads", "head_dim"), "scaled", fan_in_axes=(0,)),
        "wv": ParamDef((D, K, hd), ("embed", "kv_heads", "head_dim"), "scaled", fan_in_axes=(0,)),
        "wo": ParamDef((H, hd, D), ("heads", "head_dim", "embed"), "scaled", fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((H, hd), ("heads", "head_dim"), "zeros")
        d["bk"] = ParamDef((K, hd), ("kv_heads", "head_dim"), "zeros")
        d["bv"] = ParamDef((K, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), (None,), "ones")
        d["k_norm"] = ParamDef((hd,), (None,), "ones")
    return d


def _proj(x, w):
    """x (B, S, D) @ w (D, H, k) -> (B, S, H, k)."""
    D, H, k = w.shape
    return (x @ w.reshape(D, H * k).to(x.dtype)).reshape(*x.shape[:-1], H, k)


def project_q(p, x, cfg: ModelConfig, positions, groups: int):
    """x: (B,S,D) -> q (B,S,groups,H/groups,h), bias, qk-norm and rope
    applied; H is wq's head count (a rank's own heads under tensor
    parallelism)."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    return q.reshape(*x.shape[:2], groups, -1, cfg.head_dim)


def project_kv(p, x, cfg: ModelConfig, positions):
    """x: (B,S,D) -> k, v (B,S,K,h), bias, qk-norm and rope applied."""
    dt = x.dtype
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(k, positions, cfg.rope_theta), v


def project_qkv(p, x, cfg: ModelConfig, positions, q_groups=None):
    """x: (B,S,D) -> q (B,S,K,G,h), k/v (B,S,K,h); rope + qk-norm applied.
    The head counts are the weights' (a rank's own heads under tensor
    parallelism); q's K is k's, or ``q_groups`` when given (q as
    (B,S,q_groups,H/q_groups,h))."""
    k, v = project_kv(p, x, cfg, positions)
    return project_q(p, x, cfg, positions, q_groups or k.shape[2]), k, v


def blocked_attention(q, k, v, *, chunk: int, causal: bool,
                      q_positions=None, kv_offset: int = 0):
    """Flash attention.  q: (B,Sq,K,G,h); k,v: (B,Sk,K,h).
    Returns (B,Sq,K,G,h), with a gradient for q, k and v when they
    require one.  ``q_positions`` may only be ``arange(Sq) + kv_offset``
    (every call the JAX models make, the training forward's ``arange(S)``
    among them); the CUDA kernels, forward and backward, take the first
    position as an offset.  Checking them reads them on the host, so the
    port's models pass ``kv_offset`` alone."""
    Sq = q.shape[1]
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    assert Sk % chunk == 0, (Sk, chunk)
    if q_positions is not None:
        want = torch.arange(Sq, device=q_positions.device) + kv_offset
        if not torch.equal(q_positions.to(want.dtype), want):
            raise ValueError("q_positions must be arange(Sq) + kv_offset")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, q_offset=kv_offset, chunk=chunk)


def decode_attention(q, k_cache, v_cache, pos, cut=None):
    """Single-token attention over the cache.

    q: (B,1,K,G,h); caches: (B,Smax,K,h); pos: current position.
    Positions > pos are masked.  ``cut`` (a ``parallel.SeqCut``): the
    caches are this rank's block of a cache cut on S; each rank takes
    its f32 max m_r, sum l_r and output o_r over its positions, then one
    all-reduce MAX of m and one all-reduce SUM of [l_r, o_r] e^(m_r - M)
    over the cut's axes give o / l.  A rank whose whole block lies past
    pos has m_r = NEG_INF, so its scale e^(m_r - M) is exactly 0."""
    B, _, K, G, h = q.shape
    Smax = k_cache.shape[1]
    scale = torch.tensor(h ** -0.5, dtype=q.dtype)
    s = torch.einsum("bokgh,bskh->bkgs", (q * scale).float(),
                     k_cache.float())
    if cut is None:
        valid = torch.arange(Smax, device=q.device)[None, None, None, :] <= pos
        s = torch.where(valid, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskh->bkgh", w, v_cache.float())
        return out.reshape(B, 1, K, G, h).to(q.dtype)
    first = cut.index * Smax
    valid = torch.arange(first, first + Smax, device=q.device) <= pos
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                         # (B,K,G,1)
    p = torch.exp(s - m)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    big = par.all_reduce_(m.clone(), cut.mesh, cut.axes, dist.ReduceOp.MAX)
    c = torch.exp(m - big)
    lo = par.all_reduce_(torch.cat([p.sum(-1, keepdim=True) * c, o * c], -1),
                         cut.mesh, cut.axes)
    out = lo[..., 1:] / lo[..., :1]
    return out.reshape(B, 1, K, G, h).to(q.dtype)


def attn_out(p, ctx, cfg: ModelConfig):
    """ctx: (B,S,K,G,h) -> (B,S,D)."""
    B, S = ctx.shape[:2]
    wo = p["wo"].reshape(cfg.n_heads * cfg.head_dim, cfg.d_model)
    return ctx.reshape(B, S, cfg.n_heads * cfg.head_dim) @ wo.to(ctx.dtype)


def update_cache(cache, new, pos, mode: str = "dus", cut=None):
    """Write new (B,1,K,h) into cache (B,S,K,h) at sequence index pos, in
    place (the JAX code returns an updated copy), and return the cache.
    ``pos`` is clamped into the cache as ``dynamic_update_slice`` does;
    both modes ("dus", "onehot") write the same values.  ``cut``: the
    cache is this rank's block of a cache cut on S (``parallel.SeqCut``),
    written only by the rank that owns pos, at its local index."""
    if mode not in ("dus", "onehot"):
        raise ValueError(f"unknown cache update mode {mode!r}")
    S = cache.shape[1]
    pos = min(max(int(pos), 0), S * (1 if cut is None else cut.n) - 1)
    if cut is not None:
        owner, pos = cut.owner(pos, S)
        if owner != cut.index:
            return cache
    cache[:, pos] = new[:, 0].to(cache.dtype)
    return cache


def fill_cache(cache, new, cut=None):
    """A prefill's keys or values new (B,S,K,h) into positions [0, S) of
    cache (B,Smax,K,h), in place; with ``cut``, this rank's block of a
    cache cut on S takes the positions it holds."""
    first = 0 if cut is None else cut.index * cache.shape[1]
    n = min(max(new.shape[1] - first, 0), cache.shape[1])
    cache[:, :n] = new[:, first:first + n]
    return cache
