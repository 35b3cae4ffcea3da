"""Decoder-only transformer LM (the dense, MoE and VLM families):
training forward and loss, prefill and decode.

Copied from ``src/repro/models/transformer.py``.  Layers are stacked on
a leading axis, as in the JAX pytree, and run in a Python loop over
``LMBase.layer`` slices, so a layer's gradients land in the stacked
leaves; under FSDP each unit's slice is gathered over the data axes
inside the unit (so again in its recompute) and its gradient
reduce-scattered to the shard.  A unit is one layer, or for MoE configs with
``moe.every`` = e > 1 the e layers {"dense0", ..., "moe_layer"} that
JAX's scan stacks together; the MoE layers' aux losses are summed in
f32 over units and added to the loss.  ``cfg.remat`` maps onto
``torch.utils.checkpoint`` (non-reentrant): "none" saves everything,
"full" recomputes each unit in the backward, "dots" saves only the
outputs of matrix products without batch dimensions (JAX's
``dots_with_no_batch_dims_saveable``), and ``scan_block`` > 0 wraps
groups of that many units in one more checkpoint, as the JAX two-level
scan does.  Every setting gives the same numbers.  Under FSDP a unit's
gather runs where the unit's forward runs: once, then in the recompute
("full", "dots"), and under the two-level remat a third time in its
group's recompute, but for the group's last unit, whose recompute
PyTorch's early stop skips; with "none" every gathered unit is saved
for the backward, as JAX without ``jax.checkpoint`` keeps them.

With a plan whose "model" axis has more than one process, the layers
run split over it (``LMBase.tp``, a ``parallel.TensorParallel``), with
``distributed/parallel.py``'s collectives where the JAX model constrains
(``src/repro/models/transformer.py:95-123``).  Attention is head-
parallel where the query heads divide the axis: each rank holds H/m
query heads and K/m kv heads (wq, wk, wv, their biases and wo cut on
the head dims), or, where the kv heads do not divide it, projects k and
v whole from the replicated wk / wv and keeps the kv head of each of
its H/m query heads (JAX ``:110-118``); wo is row-parallel.  Where the
query heads do not divide the axis, attention is sequence-parallel
(JAX ``:119-123``): every rank holds every head, computes q for its S/m
query rows and k / v for the whole sequence, and the kernels take the
rows' causal offset; the rows' outputs are gathered on S.  The MLP is
column-parallel (w_gate, w_up) then row-parallel (w_down) when
``rules["mlp"]`` is "model"; the MoE layers are expert-parallel, or
where the experts do not divide the axis cut each expert's d_ff_expert
(``moe.moe_block``'s ``tp``); the embedding and the loss are
vocab-parallel.  Over a replicated residual stream each split block
starts with f and ends with g (f32 partial sums, cast once); with
``seq_shard_activations`` (``plan.resid_seq``, Megatron-SP) the stream
is cut on S, each block starts with an all-gather on S and ends with a
reduce-scatter, and the loss gathers S first.  Without a plan, or with
a "model" axis of one, every op is the one-card one.

Serving under a plan (``LMBase``): the prefill runs the layers as
training does, the SP fallback taking a prompt of any length (blocks of
ceil(S/m) query rows, the last ones padding, the outputs gathered and
trimmed, as GSPMD pads); each rank writes its block of the KV cache
(``launch/programs.py`` ``cache_specs``: its kv heads where they divide
"model"; else every kv head over its positions, the cache cut on S over
"model"; and over the data axes a batch of 1 leaves spare).  A decode
step runs the stream whole: its heads against its cache block, the
query heads all-gathered where only the cache's S is cut, the partial
softmaxes combined over the cache's sequence axes
(``attention.decode_attention``), a row-parallel wo; the logits are
all-gathered from the vocab shards.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as par
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models.moe import moe_block, moe_defs
from repro_torch.utils.params import ParamDef, tree_map


def _stack_defs(defs, n: int):
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layer",) + d.axes, d.init,
                           d.dtype, tuple(a + 1 for a in d.fan_in_axes)),
        defs)


def _dots_context():
    """Selective-checkpoint contexts that save the outputs of matrix
    products without batch dimensions (x @ W folds to mm; attention's
    einsums are bmm) and recompute everything else."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    dots = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def remat(fn, cfg: ModelConfig):
    """``fn`` under the recompute policy ``cfg.remat`` ("none", "dots",
    "full")."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_context)
    raise ValueError(f"unknown remat {cfg.remat!r}: none, dots, full")


class TransformerLM(cm.LMBase):
    def __init__(self, cfg: ModelConfig, plan=None):
        super().__init__(cfg, plan)
        # {depth: (B, S, k) expert ids} replacing the router's top-k in
        # the MoE layer at that depth (``moe_block``'s ``routes``); None
        # on every normal path
        self.routes = None
        # when a dict, each MoE layer writes the routes it took there
        self.seen_routes = None

    # ------------------------------------------------------------ params
    def _dense_layer_defs(self):
        cfg = self.cfg
        return {
            "ln1": cm.norm_defs(cfg), "attn": att.attn_defs(cfg),
            "ln2": cm.norm_defs(cfg), "mlp": cm.mlp_defs(cfg),
        }

    def _moe_layer_defs(self):
        cfg = self.cfg
        return {
            "ln1": cm.norm_defs(cfg), "attn": att.attn_defs(cfg),
            "ln2": cm.norm_defs(cfg), "moe": moe_defs(cfg),
        }

    def _unit_defs(self):
        """One stacked unit: (n_units, defs)."""
        cfg = self.cfg
        if cfg.moe is None:
            return cfg.n_layers, self._dense_layer_defs()
        e = cfg.moe.every
        if e == 1:
            return cfg.n_layers, self._moe_layer_defs()
        assert cfg.n_layers % e == 0
        unit = {"moe_layer": self._moe_layer_defs()}
        for i in range(e - 1):
            unit[f"dense{i}"] = self._dense_layer_defs()
        return cfg.n_layers // e, unit

    def _param_defs_raw(self):
        cfg = self.cfg
        n_units, unit = self._unit_defs()
        return {
            "embed": cm.embed_defs(cfg),
            "layers": _stack_defs(unit, n_units),
            "final_norm": cm.norm_defs(cfg),
        }

    def _unit_layers(self, params, u):
        """(depth, layer params) of unit u's layers in depth order."""
        per = self.cfg.moe.every if self.cfg.moe else 1
        p_u = self.layer(params, "layers", u)
        if per == 1:
            return [(u, p_u)]
        names = [f"dense{i}" for i in range(per - 1)] + ["moe_layer"]
        return [(u * per + j, p_u[nm]) for j, nm in enumerate(names)]

    def _layers(self, params):
        """(depth, layer params) over every layer in depth order, a unit
        at a time."""
        n_units, _ = self._unit_defs()
        return (dp for u in range(n_units)
                for dp in self._unit_layers(params, u))

    def _kv_of_heads(self, k, v, Hm):
        """k / v (B, S, K, h) projected whole (the kv heads do not divide
        the "model" axis) -> the kv head of each of this rank's Hm query
        heads, (B, S, Hm, h), as repeating them to H heads and cutting H
        would give (JAX ``_constrain_qkv``)."""
        idx = (torch.arange(Hm, device=k.device)
               + self.tp.rank * Hm) // self.cfg.q_per_kv
        return k.index_select(2, idx), v.index_select(2, idx)

    def _tp_attention(self, pa, hq, hkv, positions, causal, cross=False):
        """Attention under the split over "model", hq (B, S, D) the
        normed queries' stream and hkv the keys' (the same tensor for
        self-attention, the encoder memory for cross-attention), both in
        the residual stream's layout -> (the output to add to hq's
        stream, k, v).  ``cross``: the projections without bias,
        qk-norm or RoPE (``encdec.EncDecLM``'s cross-attention).

        Head-parallel (JAX ``_constrain_qkv`` ``:104-118``): this rank's
        H/m query heads and K/m kv heads (or the kv head of each of its
        query heads, projected whole), row-parallel wo.  Sequence-
        parallel where the heads do not divide the axis (``:119-123``):
        this rank's ceil(S/m) query rows, every head, k / v over the whole
        sequence, the kernels' causal offset at the rows' first
        position; the rows' outputs gathered on S (under Megatron-SP
        they stay this rank's rows)."""
        cfg, tp, plan = self.cfg, self.tp, self.plan
        if cross:
            def proj_q(h, pos, groups):
                return att._proj(h, pa["wq"]).reshape(
                    *h.shape[:2], groups, -1, cfg.head_dim)

            def proj_kv(h, pos):
                return att._proj(h, pa["wk"]), att._proj(h, pa["wv"])
        else:
            def proj_q(h, pos, groups):
                return att.project_q(pa, h, cfg, pos, groups)

            def proj_kv(h, pos):
                return att.project_kv(pa, h, cfg, pos)
        # the keys' stream whole on every rank; the queries' too, but for
        # the rows of this rank under sequence parallel Megatron-SP
        kv_in = tp.enter(hkv)
        own_rows = tp.seq and not plan.shard_heads
        q_in = hq if own_rows else kv_in if hkv is hq else tp.enter(hq)
        k, v = proj_kv(kv_in, positions)
        if plan.shard_heads:
            Hm = pa["wq"].shape[1]
            q = proj_q(q_in, positions, k.shape[2] if plan.kv_ok else Hm)
            kc, vc = (k, v) if plan.kv_ok else self._kv_of_heads(k, v, Hm)
            ctx = att.blocked_attention(q, kc, vc, chunk=cfg.attn_chunk,
                                        causal=causal)
            B, S = ctx.shape[:2]
            wo = pa["wo"]
            return tp.row_parallel(ctx.reshape(B, S, -1),
                                   wo.reshape(-1, wo.shape[-1])), k, v
        # blocks of ceil(S/m) rows, as GSPMD pads an uneven dim: a prompt
        # of any length; the padding's outputs are trimmed after the gather
        S = hq.shape[1] * (tp.size if own_rows else 1)
        first, c = par.padded_rows(S, tp.mesh)
        if not own_rows:
            q_in = torch.nn.functional.pad(
                q_in, (0, 0, 0, c * tp.size - S))[:, first:first + c]
        # positions is arange(S), as the kernel's kv_offset assumes
        q = proj_q(q_in, torch.arange(first, first + c, device=q_in.device),
                   k.shape[2])
        ctx = att.blocked_attention(q, k, v, chunk=cfg.attn_chunk,
                                    causal=causal,
                                    kv_offset=first if causal else 0)
        o = att.attn_out(pa, ctx, cfg)
        if tp.seq:
            return o, k, v
        return par.gather_seq_replicated(o, tp.mesh)[:, :S], k, v

    # ------------------------------------------------------------ layers
    def _attn_block(self, p, x, positions, causal=True):
        """Pre-norm self-attention (causal unless ``causal`` is False)
        with residual over (B,S,D); returns (x + o, k, v) so a caller can
        keep the KV cache."""
        cfg = self.cfg
        h = cm.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        if self.tp is not None:
            o, k, v = self._tp_attention(p["attn"], h, h, positions, causal)
            return x + o, k, v
        q, k, v = att.project_qkv(p["attn"], h, cfg, positions)
        # positions is arange(S) (prefill), the kernel's kv_offset = 0;
        # passing it on would cost a device sync to check
        ctx = att.blocked_attention(q, k, v, chunk=cfg.attn_chunk,
                                    causal=causal)
        return x + att.attn_out(p["attn"], ctx, cfg), k, v

    def _ffn_block(self, p, x, depth=None, tp=None):
        """Pre-norm MLP or MoE block with residual -> (x + out, aux):
        the MoE layer's aux loss (f32), 0.0 for an MLP.  ``tp``: the
        split (``self.tp`` when None)."""
        cfg = self.cfg
        tp = tp or self.tp
        h = cm.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        if "moe" not in p:
            return x + self._mlp(p["mlp"], h, tp), 0.0
        routes = None if self.routes is None else self.routes.get(depth)
        rec = None if self.seen_routes is None else {}
        out, aux = moe_block(p["moe"], h, cfg, routes=routes, record=rec,
                             tp=tp)
        if rec is not None:
            self.seen_routes[depth] = rec["experts"].view(
                h.shape[0], -1, cfg.moe.top_k).detach()
        return x + out, aux

    def _unit(self, params, u, x, positions):
        """Unit u on x (B,S,D): each layer's attention and FFN blocks ->
        (x, the unit's aux loss, f32)."""
        aux = torch.zeros((), device=x.device)
        for depth, p in self._unit_layers(params, u):
            x, _, _ = self._attn_block(p, x, positions)
            x, a = self._ffn_block(p, x, depth)
            aux = aux + a
        return x, aux

    # ------------------------------------------------------------- train
    def forward(self, params, tokens):
        """tokens (B,S) -> (final hidden states (B,S,D), aux loss: the
        MoE layers' summed, f32; 0.0 without MoE)."""
        cfg = self.cfg
        params = self.view(params)
        x = self._embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        body = remat(lambda u, h: self._unit(params, u, h, positions), cfg)
        n, blk = self._unit_defs()[0], cfg.scan_block
        aux = torch.zeros((), device=x.device)
        if cfg.scan_layers and blk and n % blk == 0:
            # two-level (sqrt) remat: the outer checkpoint keeps only each
            # group's input; the group's units are recomputed in backward
            def group(g, h):
                a_g = torch.zeros((), device=h.device)
                for u in range(g * blk, (g + 1) * blk):
                    h, a = body(u, h)
                    a_g = a_g + a
                return h, a_g
            group_body = remat(group, cfg)
            for g in range(n // blk):
                x, a = group_body(g, x)
                aux = aux + a
        else:
            for u in range(n):
                x, a = body(u, x)
                aux = aux + a
        return self._final(params, x, aux)

    def _decode_heads(self, pa, q, kc, vc, pos, tp):
        """One decode step's attention through the rank's heads: q
        (B,1,Hl,h) this rank's query heads (every head without a head
        split) at pos, over this rank's cache kc/vc (B,Sl,Kl,h), written
        already -> the output to add to the stream (B,1,D).

        - No split, or sequence-parallel attention (every head on every
          rank): whole wo.
        - Heads and kv heads split: the rank's heads over its kv heads,
          row-parallel wo.
        - Heads split, kv heads not (the cache cut on S over "model"):
          the query heads all-gathered (B·H·h), every head's partial
          softmax over the rank's positions, the rank's heads' context
          through the row-parallel wo.
        Over a cache cut on S (``cache_cut``) the partial softmaxes are
        combined (``attention.decode_attention``)."""
        cfg, plan, cut = self.cfg, self.plan, self.cache_cut
        B, _, Hl, h = q.shape
        Kl = kc.shape[2]
        if tp is None or not plan.shard_heads or plan.kv_ok:
            ctx = att.decode_attention(q.reshape(B, 1, Kl, -1, h), kc, vc,
                                       pos, cut)
            if tp is None or not plan.shard_heads:
                return att.attn_out(pa, ctx, cfg)
            wo = pa["wo"]
            return tp.row_parallel(ctx.reshape(B, 1, -1),
                                   wo.reshape(-1, wo.shape[-1]))
        qa = par.all_gather(q, 2, tp.mesh, "model")
        ctx = att.decode_attention(qa.reshape(B, 1, Kl, -1, h), kc, vc, pos,
                                   cut).reshape(B, 1, -1, h)
        mine = ctx[:, :, tp.rank * Hl:(tp.rank + 1) * Hl].reshape(B, 1, -1)
        wo = pa["wo"]
        return tp.row_parallel(mine, wo.reshape(-1, wo.shape[-1]))

    def _decode_attn(self, p, x, kc, vc, pos, tp=None):
        """Self-attention of one decode step with residual: x (B,1,D);
        kc/vc (B,Smax,K,h) single-layer cache (this rank's block under a
        plan), written in place at pos; ``tp``: the split over a whole
        stream (``tp_whole``) or None."""
        cfg = self.cfg
        pa = p["attn"]
        h = cm.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        if tp is not None:
            h = tp.enter(h)
        positions = torch.full((1,), pos, device=x.device)
        k, v = att.project_kv(pa, h, cfg, positions)
        heads = pa["wq"].shape[1]
        q = att.project_q(pa, h, cfg, positions, heads)
        att.update_cache(kc, k, pos, cfg.cache_update, self.cache_cut)
        att.update_cache(vc, v, pos, cfg.cache_update, self.cache_cut)
        return x + self._decode_heads(pa, q.reshape(*q.shape[:2], heads, -1),
                                      kc, vc, pos, tp)

    def _decode_layer(self, p, x, kc, vc, pos, depth=None, tp=None):
        """One layer of a decode step: ``_decode_attn``, then the FFN."""
        x = self._decode_attn(p, x, kc, vc, pos, tp)
        x, _ = self._ffn_block(p, x, depth, tp)
        return x

    # ----------------------------------------------------------- serving
    def cache_struct(self, batch: int, max_len: int):
        cfg = self.cfg
        n_units, _ = self._unit_defs()
        L = n_units * (cfg.moe.every if cfg.moe else 1)
        sh = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": cm.CacheSpec(sh, cfg.act_dtype),
                "v": cm.CacheSpec(sh, cfg.act_dtype)}

    def decode_step(self, params, cache, token, pos):
        """token (B,), pos int -> (logits (B,Vp), cache updated in place).
        Under a plan: this rank's rows and cache block, the stream
        whole."""
        tp = self.tp_whole
        params = self.view(params)
        x = self._embed(params["embed"], token[:, None], tp)  # (B,1,D)
        for d, p_l in self._layers(params):
            x = self._decode_layer(p_l, x, cache["k"][d], cache["v"][d], pos,
                                   d, tp)
        x = cm.rms_norm(x, params["final_norm"]["scale"], self.cfg.norm_eps)
        return self._logits_last(params["embed"], x[:, 0], tp), cache

    def prefill(self, params, tokens, max_len: int):
        """tokens (B,S) -> (cache with [0:S] filled, last-token logits).
        Under a plan: this rank's rows, its block of the cache."""
        cfg = self.cfg
        B, S = tokens.shape
        params = self.view(params)
        x = self._embed(params["embed"], tokens)
        positions = torch.arange(S, device=x.device)
        cache = self.init_cache(B * self.batch_shards, max(max_len, S))
        cut = self.cache_cut
        for d, p_l in self._layers(params):
            x, k, v = self._attn_block(p_l, x, positions)
            x, _ = self._ffn_block(p_l, x, d)
            att.fill_cache(cache["k"][d], k, cut)
            att.fill_cache(cache["v"][d], v, cut)
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return cache, self._logits_last(params["embed"], self._last_row(x))
