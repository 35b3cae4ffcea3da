"""Mamba2 (SSD, state-space duality) LM: training forward and loss,
prefill and decode.

Copied from ``src/repro/models/mamba2.py``.  The SSD forward is the
chunked matmul form (arXiv:2405.21060 §6): quadratic attention-like
products within chunks and a sequential scan over chunk states; on CUDA
tensors ``ssd_chunked`` runs the kernels of ``kernels.ssd_scan``, whose
backward is a kernel too.  The training forward runs the layers in a
Python loop over ``LMBase.layer`` slices, each under ``remat`` (one
checkpoint per layer, as JAX's ``_remat`` body); under FSDP the slice
is gathered inside the checkpoint, so again in its recompute.
Decode is the O(1) recurrent step on (H, N, hd) states.  Under a plan
that splits the SSM heads, prefill and decode run on the rank's heads
and d_in columns: its cache holds their states and conv_x columns
(``launch/programs.py`` ``cache_specs``), conv_B / conv_C whole.  Under
a plan that splits "model" but not the heads (``mamba_layer``), a layer
runs whole on every rank: its d_in-cut leaves gathered at its entry, a
residual stream cut on S gathered and this rank's rows kept at its exit,
the cache's conv_x columns gathered and cut back.  n_groups = 1
(B/C shared across heads), as in the published 780m config.  z, x, B, C
and dt have separate projection and conv parameters, as in the JAX
package: mathematically the fused in_proj of the reference
implementation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as par
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import common as cm
from repro_torch.models.transformer import _stack_defs, remat
from repro_torch.utils.params import ParamDef, make_specs, tree_map


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    H = d_in // s.head_dim
    return d_in, H


def mamba_defs(cfg: ModelConfig):
    s = cfg.ssm
    D = cfg.d_model
    d_in, H = _dims(cfg)
    N = s.d_state
    W = s.conv_width
    return {
        "w_z": ParamDef((D, d_in), ("embed", "ssm_inner"), "scaled"),
        "w_x": ParamDef((D, d_in), ("embed", "ssm_inner"), "scaled"),
        "w_B": ParamDef((D, N), ("embed", "ssm_state"), "scaled"),
        "w_C": ParamDef((D, N), ("embed", "ssm_state"), "scaled"),
        "w_dt": ParamDef((D, H), ("embed", "ssm_head"), "scaled"),
        "conv_x": ParamDef((W, d_in), (None, "ssm_inner"), "scaled"),
        "conv_bx": ParamDef((d_in,), ("ssm_inner",), "zeros"),
        "conv_B": ParamDef((W, N), (None, "ssm_state"), "scaled"),
        "conv_bB": ParamDef((N,), ("ssm_state",), "zeros"),
        "conv_C": ParamDef((W, N), (None, "ssm_state"), "scaled"),
        "conv_bC": ParamDef((N,), ("ssm_state",), "zeros"),
        "A_log": ParamDef((H,), ("ssm_head",), "ones"),
        "dt_bias": ParamDef((H,), ("ssm_head",), "zeros"),
        "D_skip": ParamDef((H,), ("ssm_head",), "ones"),
        "norm": ParamDef((d_in,), ("ssm_inner",), "ones"),
        "out_proj": ParamDef((d_in, D), ("ssm_inner", "embed"), "scaled"),
        "ln": cm.norm_defs(cfg),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x (B,S,C), w (W,C)."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _conv_step(x_t, state, w, b):
    """x_t (B,C) newest input; state (B,W-1,C) raw history."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)       # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window, w)
    return F.silu(out + b), window[:, 1:, :]


def ssd_chunked(x, B_, C_, dt, A_log, chunk: int, init_state=None):
    """SSD chunked matmul form.

    x (B,S,H,hd); B_/C_ (B,S,N); dt (B,S,H) post-softplus; A_log (H,).
    Returns (y (B,S,H,hd) fp32, final_state (B,H,N,hd) fp32)."""
    S = x.shape[1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    return ssd_scan(x, dt, A_log, B_, C_, chunk=Q, init_state=init_state)


def mamba_block(p, x, cfg: ModelConfig, return_state: bool = False,
                tp=None):
    """Pre-norm residual mamba2 mixer on (B,S,D).

    ``tp``: the model's split over "model" (``parallel.TensorParallel``;
    ``rules["ssm_inner"]`` and ``["ssm_head"]`` "model"), or None.  The
    normed input enters the split whole; w_z, w_x, conv_x / conv_bx,
    w_dt, dt_bias, A_log, D_skip and the gated norm's scale are this
    rank's d_in/m columns and H/m heads (the weights' shapes), so the
    scan runs on its heads; B and C (w_B, w_C and their convolutions)
    are whole, each rank using them for its heads (model-partial
    leaves); the gated norm sums its squares over "model"
    (``parallel.rms_norm_cut``) and out_proj is row-parallel."""
    s = cfg.ssm
    dt_ = x.dtype
    h = cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    if tp is not None:
        h = tp.enter(h)
    Bb, S = h.shape[:2]
    d_in, H = p["w_x"].shape[-1], p["A_log"].shape[-1]
    z = h @ p["w_z"].to(dt_)
    xr = h @ p["w_x"].to(dt_)                                  # raw conv input
    Br = h @ p["w_B"].to(dt_)
    Cr = h @ p["w_C"].to(dt_)
    dtl = h @ p["w_dt"].to(dt_)
    xc = _causal_conv(xr, p["conv_x"].to(dt_), p["conv_bx"].to(dt_))
    Bc = _causal_conv(Br, p["conv_B"].to(dt_), p["conv_bB"].to(dt_))
    Cc = _causal_conv(Cr, p["conv_C"].to(dt_), p["conv_bC"].to(dt_))
    xc_ = xc.reshape(Bb, S, H, s.head_dim)
    dt = F.softplus(dtl.float() + p["dt_bias"].float())
    y, fstate = ssd_chunked(xc_, Bc, Cc, dt, p["A_log"], s.chunk)
    y = y.to(dt_) + p["D_skip"].to(dt_)[None, None, :, None] * xc_
    y = y.reshape(Bb, S, d_in)
    y = y * F.silu(z)
    if tp is not None:
        y = par.rms_norm_cut(y, p["norm"], cfg.norm_eps, tp.mesh)
        out = tp.row_parallel(y, p["out_proj"])
    else:
        y = cm.rms_norm(y, p["norm"], cfg.norm_eps)
        out = y @ p["out_proj"].to(dt_)
    if return_state:
        W = s.conv_width
        tails = (xr[:, -(W - 1):, :], Br[:, -(W - 1):, :], Cr[:, -(W - 1):, :])
        return x + out, (tails, fstate.to(dt_))
    return x + out, None


def mamba_decode(p, x, cfg: ModelConfig, conv_x, conv_B, conv_C, ssm_state,
                 tp=None):
    """One-token step. x (B,1,D); conv_* raw history; ssm_state (B,H,N,hd).
    ``tp``: the split over "model" (``mamba_block``'s): the rank's d_in/m
    columns of conv_x and H/m heads of ssm_state, the gated norm over
    the cut, a row-parallel out_proj."""
    s = cfg.ssm
    d_in, H = p["w_x"].shape[-1], p["A_log"].shape[-1]
    dt_ = x.dtype
    h = cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)[:, 0]   # (B,D)
    if tp is not None:
        h = tp.enter(h)
    z = h @ p["w_z"].to(dt_)
    xr = h @ p["w_x"].to(dt_)
    Br = h @ p["w_B"].to(dt_)
    Cr = h @ p["w_C"].to(dt_)
    dtl = h @ p["w_dt"].to(dt_)
    xc, ncx = _conv_step(xr, conv_x, p["conv_x"].to(dt_), p["conv_bx"].to(dt_))
    Bc, ncB = _conv_step(Br, conv_B, p["conv_B"].to(dt_), p["conv_bB"].to(dt_))
    Cc, ncC = _conv_step(Cr, conv_C, p["conv_C"].to(dt_), p["conv_bC"].to(dt_))
    x_ssm = xc.reshape(-1, H, s.head_dim)
    dt = F.softplus(dtl.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)                                      # (B,H)
    xd = x_ssm.float() * dt[..., None]
    new_state = (ssm_state.float() * a[:, :, None, None]
                 + torch.einsum("bn,bhp->bhnp", Bc.float(), xd))
    y = torch.einsum("bn,bhnp->bhp", Cc.float(), new_state)
    y = y.to(dt_) + p["D_skip"].to(dt_)[None, :, None] * x_ssm
    y = y.reshape(-1, d_in)
    y = y * F.silu(z)
    if tp is not None:
        y = par.rms_norm_cut(y, p["norm"], cfg.norm_eps, tp.mesh)
        out = tp.row_parallel(y, p["out_proj"])[:, None, :]
    else:
        y = cm.rms_norm(y, p["norm"], cfg.norm_eps)
        out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return x + out, (ncx, ncB, ncC), new_state.to(dt_)


def ssm_split(model, tp=None):
    """``tp`` (``model.tp`` when None) where the model's plan splits the
    SSM heads over "model" (``ssm_head``, and then ``ssm_inner``: d_in
    = H * head_dim), else None."""
    tp = tp or model.tp
    return tp if tp is not None and tp.plan.rules["ssm_head"] else None


def _whole_layer(model, p, mesh):
    """A mamba layer's parameters ``p`` with the leaves that "model" cuts
    (d_in, ``ssm_inner``, where the heads are not split: w_z, w_x,
    conv_x, conv_bx, norm, out_proj) gathered over it
    (``parallel.gather_model``: the backward takes this rank's block).
    While the layer runs a rank holds its d_in leaves whole:
    (3 D + W + 2) d_in elements."""
    specs = make_specs(mamba_defs(model.cfg), model.plan.rules)
    return tree_map(lambda x, sp: par.gather_model(x, sp, mesh), p, specs)


def _cut_inner(model, t, mesh):
    """This rank's block of a tensor's last dim (d_in) where the plan
    cuts ``ssm_inner`` (a cache's conv_x columns), else ``t``."""
    if not model.plan.rules["ssm_inner"]:
        return t
    return par.block(t, t.ndim - 1, mesh, ("model",))


def mamba_layer(model, p, x, return_state: bool = False, tp=None):
    """``mamba_block`` of one of ``model``'s layers under its plan (``tp``,
    ``model.tp`` when None).  Where the plan splits the SSM heads, the
    block's split.  Where it splits "model" but not the heads (d_in
    divides the axis, H does not; or neither does), the layer runs
    whole on every rank, as JAX computes it with no constraint on the
    heads: its d_in-cut leaves gathered (``_whole_layer``); a residual
    stream cut on S (``resid_seq``) gathered at the entry
    (``gather_seq_replicated``) and this rank's rows kept at the exit
    (``keep_seq_rows``: the gradient all-gathered, so the backward runs
    whole too and no weight's gradient is partial); the conv_x tail
    returned is this rank's d_in columns, as the cache holds them."""
    tp = tp or model.tp
    if tp is None or ssm_split(model, tp) is not None:
        return mamba_block(p, x, model.cfg, return_state, tp)
    mesh = tp.mesh
    p = _whole_layer(model, p, mesh)
    if tp.seq:
        x = par.gather_seq_replicated(x, mesh)
    y, state = mamba_block(p, x, model.cfg, return_state)
    if tp.seq:
        y = par.keep_seq_rows(y, mesh)
    if state is not None:
        (xr, Br, Cr), st = state
        state = ((_cut_inner(model, xr, mesh), Br, Cr), st)
    return y, state


def ssm_cache_struct(cfg: ModelConfig, batch: int):
    """The recurrent part of a cache: raw conv history and SSD state per
    mamba layer."""
    s = cfg.ssm
    d_in, H = _dims(cfg)
    L, W, N = cfg.n_layers, s.conv_width, s.d_state
    f = lambda sh: cm.CacheSpec(sh, cfg.act_dtype)  # noqa: E731
    return {
        "conv_x": f((L, batch, W - 1, d_in)),
        "conv_B": f((L, batch, W - 1, N)),
        "conv_C": f((L, batch, W - 1, N)),
        "state": f((L, batch, H, N, s.head_dim)),
    }


def decode_layer(model, p, x, cache, i, tp=None):
    """``mamba_decode`` of ``model``'s layer i against its slices of
    ``cache``, written back in place (the JAX code stacks new cache
    arrays).  ``tp``: the split over a whole stream (``tp_whole``) or
    None; where it does not split the SSM heads, the step runs whole
    (``mamba_layer``): the d_in leaves and the cache's conv_x columns
    gathered over "model", this rank's columns written back."""
    cfg = model.cfg
    conv_x = cache["conv_x"][i]
    whole = tp is not None and ssm_split(model, tp) is None
    if whole:
        p = _whole_layer(model, p, tp.mesh)
        if model.plan.rules["ssm_inner"]:
            conv_x = par.all_gather(conv_x, conv_x.ndim - 1, tp.mesh,
                                    "model")
    x, (ncx, ncb, ncc), ns = mamba_decode(
        p, x, cfg, conv_x, cache["conv_B"][i], cache["conv_C"][i],
        cache["state"][i], None if whole else tp)
    if whole:
        ncx = _cut_inner(model, ncx, tp.mesh)
    cache["conv_x"][i] = ncx
    cache["conv_B"][i] = ncb
    cache["conv_C"][i] = ncc
    cache["state"][i] = ns
    return x


class Mamba2LM(cm.LMBase):
    def _param_defs_raw(self):
        cfg = self.cfg
        return {
            "embed": cm.embed_defs(cfg),
            "layers": _stack_defs(mamba_defs(cfg), cfg.n_layers),
            "final_norm": cm.norm_defs(cfg),
        }

    # ------------------------------------------------------------- train
    def forward(self, params, tokens):
        """tokens (B,S) -> (final hidden states (B,S,D), aux loss 0.0)."""
        cfg = self.cfg
        params = self.view(params)
        x = self._embed(params["embed"], tokens)
        body = remat(lambda i, h: mamba_layer(
            self, self.layer(params, "layers", i), h)[0], cfg)
        for i in range(cfg.n_layers):
            x = body(i, x)
        return self._final(params, x)

    # ----------------------------------------------------------- serving
    def cache_struct(self, batch: int, max_len: int):
        return ssm_cache_struct(self.cfg, batch)

    def decode_step(self, params, cache, token, pos):
        """token (B,) -> (logits (B,Vp), cache updated in place).  Under a
        plan: this rank's rows, SSM heads and conv_x columns."""
        cfg = self.cfg
        tp = self.tp_whole
        params = self.view(params)
        x = self._embed(params["embed"], token[:, None], tp)
        for i in range(cfg.n_layers):
            x = decode_layer(self, self.layer(params, "layers", i), x,
                             cache, i, tp)
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._logits_last(params["embed"], x[:, 0], tp), cache

    def prefill(self, params, tokens, max_len: int):
        """tokens (B,S) -> (cache: each layer's conv tails and final SSD
        state, last-token logits).  Under a plan: this rank's rows, the
        scan on its heads (their states and conv_x columns kept)."""
        cfg = self.cfg
        params = self.view(params)
        x = self._embed(params["embed"], tokens)
        tails, states = [], []
        for i in range(cfg.n_layers):
            x, (t3, st) = mamba_layer(self, self.layer(params, "layers", i),
                                      x, return_state=True)
            tails.append(t3)
            states.append(st)
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = self._logits_last(params["embed"], self._last_row(x))
        cache = {"conv_x": torch.stack([t[0] for t in tails]),
                 "conv_B": torch.stack([t[1] for t in tails]),
                 "conv_C": torch.stack([t[2] for t in tails]),
                 "state": torch.stack(states)}
        return cache, logits
