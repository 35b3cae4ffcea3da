"""Shared model pieces: norms, rope, embeddings, chunked losses, MLP,
and the base of the port's language models.

Copied from ``src/repro/models/common.py``.  Its hand-written VJP of
``rms_norm`` is a ``torch.autograd.Function`` with the same arithmetic
and roundings (``grad_dtype_barrier`` needs none: autograd keeps each
gradient in its tensor's dtype); ``chunked_xent`` recomputes each
chunk's logits in the backward with ``torch.utils.checkpoint``, as the
JAX code does with ``jax.checkpoint``.
"""
from __future__ import annotations

import collections
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as par
from repro_torch.utils.params import (ParamDef, PartitionSpec, init_params,
                                      is_node, make_specs, to_parameter_dict,
                                      tree_leaves, tree_map, with_dtype)

NEG_INF = -1e30

CacheSpec = collections.namedtuple("CacheSpec", ["shape", "dtype"])

# the norms on the residual stream, by parent name (Megatron-SP cuts
# them on S); the SSM's leaves on its "ssm_state" axis
RESID_NORMS = ("ln1", "ln2", "lnx", "ln", "final_norm", "enc_norm")
SSM_STATE_LEAVES = ("w_B", "w_C", "conv_B", "conv_bB", "conv_C", "conv_bC")


def _rms_inv(x, eps):
    """rsqrt(mean(x^2) + eps) over the last axis, (..., 1) f32: the sum
    of squares in f32 (the JAX code's bf16 x bf16 -> f32 einsum)."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    return torch.rsqrt(var + eps)[..., None]


class _RMSNorm(torch.autograd.Function):
    """``rms_norm`` with ``_rms_bwd``'s gradient: the cotangent path
    stays in x's dtype, the row sums and the scale's gradient are f32."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        inv = _rms_inv(x, eps)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        inv = _rms_inv(x, ctx.eps)                  # recompute: (..., 1) f32
        gs = g * scale.to(x.dtype)
        t = (gs.float() * x.float()).sum(-1, keepdim=True)
        coeff = inv ** 3 * (t / x.shape[-1])
        dx = gs * inv.to(x.dtype) - x * coeff.to(x.dtype)
        xin = x * inv.to(x.dtype)
        dscale = (g.float() * xin.float()).reshape(-1, g.shape[-1]).sum(0)
        return dx, dscale.to(scale.dtype), None


def rms_norm(x, scale, eps: float):
    """x * rsqrt(mean(x^2) + eps) * scale: the mean of squares in f32,
    the products in x's dtype; differentiable in x and scale."""
    return _RMSNorm.apply(x, scale, eps)


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


def grad_dtype_barrier(x):
    """Identity: autograd already gives every tensor a gradient of its
    own dtype, which the JAX model's custom VJP of this name enforces."""
    return x


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


def chunked_xent(p, h, targets, cfg: ModelConfig, mask=None):
    """Next-token cross-entropy in sequence chunks of ``cfg.logit_chunk``
    so (B, S, V) never materialises; each chunk's logits are recomputed
    in the backward (``torch.utils.checkpoint``).

    h: (B, S, D) final hidden states; targets: (B, S) integer; mask:
    optional (B, S), 1 for the tokens that count.  The logits are f32
    (the product of h and the unembedding rounded to h's dtype, summed in
    f32), the padded vocab masked.  Returns (mean loss over unmasked
    tokens, token count), f32."""
    w = unembed_matrix(p, cfg).to(h.dtype).float()     # (D, Vp)
    B, S, D = h.shape
    c = min(cfg.logit_chunk, S)
    if S % c:
        raise ValueError(f"logit_chunk {c} does not divide S={S}")
    pad = None
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size

    def chunk_nll(hc, tc, mc):
        logits = torch.matmul(hc.float(), w)
        if pad is not None:
            logits = torch.where(pad, NEG_INF, logits)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        return ((lse - gold) * mc).sum(), mc.sum()

    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        mc = (torch.ones((B, c), device=h.device) if mask is None
              else mask[:, sl].float())
        s_, c_ = checkpoint(chunk_nll, h[:, sl], targets[:, sl], mc,
                            use_reentrant=False)
        tot, cnt = tot + s_, cnt + c_
    return tot / torch.clamp(cnt, min=1.0), cnt


def logits_last(p, h_last, cfg: ModelConfig, mesh=None):
    """h_last: (B, D) -> (B, Vp) f32 logits with padded vocab masked.
    ``mesh``: the unembedding is this rank's vocab shard, its logits
    (B, Vp/m) all-gathered on "model" into the whole (B, Vp)."""
    w = unembed_matrix(p, cfg)
    logits = h_last.float() @ w.float()
    if mesh is not None:
        logits = par.all_gather(logits, 1, mesh, "model")
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


class FSDPView(dict):
    """A model's parameters for one forward under FSDP (``LMBase.view``):
    the leaves outside the layer stacks gathered, the stacks still this
    rank's shards (``LMBase.layer`` gathers a unit's slice at its use)."""


class LMBase(nn.Module):
    """What the port's language models share: their parameters live in
    ``self.params``, a nested ``nn.ParameterDict`` in the JAX pytree's
    layout (same keys, same stacked leading axes), and their cache
    tensors are made from ``cache_struct``.  ``forward``, ``loss``,
    ``prefill`` and ``decode_step`` take the parameters as their first
    argument, as the JAX models do.  ``plan`` is the sharding plan the
    model was made for (``models/zoo.py`` ``get_model``), None on one
    card.

    Under a plan whose data axes cut the parameters (FSDP), the model
    holds this rank's shards and gathers them one unit at a time, as
    GSPMD runs JAX's scanned layers: ``view`` gathers the leaves outside
    the layer stacks once a forward (the embedding and unembedding,
    zamba2's shared block), ``layer`` a unit's slice of a stack where the
    unit runs (inside its checkpoint, so again in its recompute), each
    through ``parallel.gather_data``, whose backward reduce-scatters the
    gradient to the shard.  Every family calls ``layer`` in place of
    ``layer_slice``; both are the plain slice on one card, where no data
    axis has more than one process, and for a model that holds
    model-local leaves (``load_serving``, ``load_local``).

    Under a plan, ``prefill`` and ``decode_step`` serve (JAX's
    ``launch/programs.py`` cells): the parameters are the rank's
    model-local leaves (``load_serving`` gathers the FSDP cut once), the
    inputs this rank's rows of the plan's batch axes, the cache this
    rank's block under ``launch/programs.py`` ``cache_specs``
    (``init_cache`` takes the global batch), and the logits every rank's
    (B, Vp).  JAX makes its prefill and decode plans from different
    shapes; one model holds one plan for both, and the only field that
    may differ between them, ``resid_seq``, a decode step ignores: it
    runs the residual stream whole (``tp_whole``), as JAX's decode plan
    sets ``resid_seq`` None."""

    def __init__(self, cfg: ModelConfig, plan=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.params = None
        # the split over "model" (``parallel.TensorParallel``), else None;
        # ``tp_whole`` the same split over a whole residual stream
        split = plan is not None and plan.model_size > 1
        self.tp = par.TensorParallel(plan) if split else None
        self.tp_whole = (par.TensorParallel(plan, seq=False) if split
                         else None)
        # True while the model holds model-local leaves (``load_local``,
        # ``load_serving``): nothing to gather
        self.model_local = False

    def param_defs(self):
        return with_dtype(self._param_defs_raw(), self.cfg.param_dtype)

    def param_specs(self):
        """The parameters' PartitionSpecs under the plan's rules."""
        assert self.plan is not None
        return make_specs(self.param_defs(), self.plan.rules)

    def model_partial_leaves(self):
        """Names of the leaves replicated over "model" whose gradient each
        rank holds only a part of (``parallel.reduce_grads``): none
        unless the model splits its work over that axis; then
        - the qk-norm scales, and wk / wv / bk / bv where the kv heads
          are projected whole (they act on this rank's heads only);
          every attention leaf under sequence parallelism (this rank's
          query rows);
        - the MoE router (this rank's experts' gates);
        - the SSM's B / C projections and convolutions (this rank's
          heads);
        - under Megatron-SP the residual stream's norms, and a
          replicated MLP's leaves (this rank's positions).
        The norms on a replicated residual stream are not: under f and
        g every rank already holds their whole gradient; nor is any leaf
        of a mamba layer whose heads the plan does not split, which runs
        whole on every rank (``mamba2.mamba_layer``)."""
        if self.tp is None:
            return frozenset()
        return frozenset(n for n, _ in tree_leaves(self.param_defs())
                         if self._partial(n.split(".")))

    def _partial(self, parts) -> bool:
        plan, seq = self.plan, self.tp.seq
        leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else None)
        if parent in ("attn", "xattn"):
            return (not plan.shard_heads or leaf in ("q_norm", "k_norm")
                    or (not plan.kv_ok and leaf in ("wk", "wv", "bk", "bv")))
        if parent == "moe":
            return leaf == "router"
        if leaf in SSM_STATE_LEAVES:
            return plan.rules["ssm_head"] == "model"
        if seq and leaf == "scale" and parent in RESID_NORMS:
            # "ln": a mamba layer's, on this rank's positions only where
            # its heads are split
            return parent != "ln" or plan.rules["ssm_head"] == "model"
        return seq and parent in ("mlp", "shared") and \
            plan.rules["mlp"] != "model"

    # --------------------------------------------- FSDP, unit by unit
    @functools.cached_property
    def stack_keys(self):
        """The top-level keys whose leaves are stacked on "layer" axes."""
        return frozenset(key for key, sub in self.param_defs().items()
                         if all(d.axes[0] == "layer"
                                for _, d in tree_leaves(sub)))

    @functools.cached_property
    def _fsdp_specs(self):
        """The parameters' specs where some data axis of the plan has more
        than one process, else None (one card, or the data axes of 1)."""
        if self.plan is None or not par.live_axes(self.plan.mesh,
                                                  self.plan.data_axes):
            return None
        return self.param_specs()

    @property
    def fsdp(self) -> bool:
        """Whether this model gathers its FSDP shards as it runs: a plan
        with a data axis of more than one process, and shards held (not
        ``load_local``'s model-local leaves)."""
        return self._fsdp_specs is not None and not self.model_local

    def _gather(self, tree, specs, stacked: int = 0):
        plan = self.plan
        return tree_map(lambda x, sp: par.gather_data(
            x, sp[stacked:], plan.mesh, plan.data_axes, plan.batch_axes),
            tree, specs)

    def view(self, params):
        """``params`` for one forward: under FSDP an ``FSDPView`` with the
        leaves outside the stacks gathered (once: a view passes through),
        else ``params`` itself."""
        if not self.fsdp or isinstance(params, FSDPView):
            return params
        out = FSDPView(params.items())
        for key, sub in params.items():
            if key not in self.stack_keys:
                out[key] = self._gather(sub, self._fsdp_specs[key])
        return out

    def layer(self, params, key: str, *index):
        """The slice ``index`` (one index per stacked axis taken) of the
        stack ``params[key]``: under FSDP each leaf gathered over the data
        axes (``parallel.gather_data``), else ``layer_slice``'s views."""
        tree = params[key]
        for i in index:
            tree = layer_slice(tree, i)
        if not self.fsdp:
            return tree
        return self._gather(tree, self._fsdp_specs[key], len(index))

    # ------------------------------------------- the split over "model"
    def _embed(self, p, tokens, tp=None):
        """The embedding lookup: vocab-parallel under a split (``tp``, or
        ``self.tp`` when None), in the residual stream's layout."""
        tp = tp or self.tp
        if tp is None:
            return embed(p, tokens, self.cfg)
        return par.vocab_embed(p["table"], tokens, tp.mesh,
                               self.cfg.act_dtype, seq=tp.seq)

    def _mlp(self, p, h, tp=None):
        """The MLP on the normed residual stream h: column-parallel
        (w_gate, w_up) then row-parallel (w_down) where ``rules["mlp"]``
        is "model", else whole (on this rank's positions under
        Megatron-SP).  ``tp``: the split (``self.tp`` when None)."""
        tp = tp or self.tp
        if tp is None or self.plan.rules["mlp"] != "model":
            return mlp(p, h)
        h = tp.enter(h)
        a = F.silu(h @ p["w_gate"].to(h.dtype)) * (h @ p["w_up"].to(h.dtype))
        return tp.row_parallel(a, p["w_down"])

    # ----------------------------------------------------------- serving
    @functools.cached_property
    def cache_cut(self):
        """The ``parallel.SeqCut`` of the cache's sequence dim
        (``plan.cache_seq``: "model" where the kv heads do not divide
        it, and the data axes the batch leaves spare), or None."""
        if self.plan is None:
            return None
        return par.seq_cut(self.plan.mesh, self.plan.cache_seq)

    @property
    def batch_shards(self) -> int:
        """The blocks the plan's batch axes cut the rows into (1 without
        a plan): a rank's prefill takes B / batch_shards rows."""
        if self.plan is None:
            return 1
        axes = par.live_axes(self.plan.mesh, self.plan.batch_axes)
        return math.prod(self.plan.mesh.shape[a] for a in axes)

    def serve_specs(self):
        """The parameters' specs with the plan's data axes dropped: the
        model-local leaves a serving rank holds."""
        data = set(self.plan.data_axes)

        def local(spec):
            return PartitionSpec(*(
                None if not kept else kept[0] if len(kept) == 1 else kept
                for kept in (tuple(a for a in par.entry_axes(e)
                                   if a not in data) for e in spec)))
        return tree_map(local, self.param_specs())

    def load_serving(self, params):
        """Hold this rank's shards ``params`` (the ``param_specs`` layout,
        as training holds them) as model-local leaves: the FSDP ("data")
        cut of every leaf gathered once here, and not again as the model
        runs (``model_local``; a decode tick would otherwise gather every
        unit for each token)."""
        if self.plan is not None:
            with torch.no_grad():
                params = par.gather_tree(params, self.param_specs(),
                                         self.plan.mesh, self.plan.data_axes)
        return self.load_local(params)

    def load_local(self, params):
        """Hold model-local leaves ``params`` (the ``serve_specs``
        layout) as this model's parameters, never gathered again as the
        model runs; returns them."""
        params = self.load(params)
        self.model_local = True
        return params

    def local_cache_struct(self, batch: int, max_len: int, **kw):
        """``cache_struct`` of the global ``batch``, each leaf's shape this
        rank's block under the plan (``launch/programs.py``)."""
        if self.plan is None:
            return self.cache_struct(batch, max_len, **kw)
        from repro_torch.launch.programs import local_cache_struct
        return local_cache_struct(self, self.plan, batch, max_len, **kw)

    def _last_row(self, x):
        """The last position's hidden state (B, D) of x (B, S, D): on the
        last rank under Megatron-SP, shared by an all-gather."""
        if self.tp is None or not self.tp.seq:
            return x[:, -1]
        return par.all_gather(x[:, -1:], 1, self.tp.mesh, "model")[:, -1]

    def _logits_last(self, p, h_last, tp=None):
        """(B, D) -> (B, Vp) f32 logits, the padded vocab masked: under a
        split (``tp``, or ``self.tp`` when None) every rank returns the
        one-card logits, its vocab shard's all-gathered."""
        tp = tp or self.tp
        return logits_last(p, h_last, self.cfg,
                           None if tp is None else tp.mesh)

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device."""
        return self.load(init_params(self.param_defs(), generator))

    def load(self, params):
        """Hold ``params`` (a nested mapping of tensors in the layout of
        ``param_defs``) as this model's parameters; returns them."""
        self.params = (params if isinstance(params, nn.ParameterDict)
                       else to_parameter_dict(params))
        self.model_local = False
        return self.params

    def _final(self, params, x, aux=None):
        """(final hidden states, aux loss: ``aux``, or 0.0) from the last
        layer's x: JAX's dtype barrier and the final norm, as every
        ``forward`` ends."""
        x = grad_dtype_barrier(x)
        x = rms_norm(x, params["final_norm"]["scale"], self.cfg.norm_eps)
        return x, torch.zeros((), device=x.device) if aux is None else aux

    def loss(self, params, batch):
        """batch: {tokens (B,S), labels (B,S)[, mask (B,S)]} -> (loss,
        metrics {ce, aux, tokens}): ``forward``'s final hidden states
        through ``chunked_xent``, as every JAX model's ``loss``."""
        params = self.view(params)
        h, aux = self.forward(params, batch["tokens"])
        ce, cnt = self._xent(params["embed"], h, batch["labels"],
                             batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux, "tokens": cnt}

    def _xent(self, p, h, targets, mask):
        """The loss head: ``chunked_xent``, vocab-parallel under a
        split."""
        if self.tp is None:
            return chunked_xent(p, h, targets, self.cfg, mask=mask)
        return par.vocab_xent(unembed_matrix(p, self.cfg), h, targets,
                              self.cfg, self.tp.mesh, mask, seq=self.tp.seq)

    @property
    def device(self) -> torch.device:
        if self.params is None:
            return torch.device("cpu")
        return next(self.params.parameters()).device

    def init_cache(self, batch: int, max_len: int, **kw):
        """A zero cache of the global ``batch``: this rank's block of each
        leaf under a plan."""
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.local_cache_struct(batch, max_len,
                                                    **kw).items()}
