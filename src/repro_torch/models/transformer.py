"""Decoder-only transformer LM (the dense family): training forward and
loss, prefill and decode.

Copied from ``src/repro/models/transformer.py`` without sharding and the
MoE units.  Layers are stacked on a leading axis, as in the JAX pytree,
and run in a Python loop over ``layer_slice`` views, so a layer's
gradients land in the stacked leaves.  ``cfg.remat`` maps onto
``torch.utils.checkpoint`` (non-reentrant): "none" saves everything,
"full" recomputes each layer in the backward, "dots" saves only the
outputs of matrix products without batch dimensions (JAX's
``dots_with_no_batch_dims_saveable``), and ``scan_block`` > 0 wraps
groups of that many layers in one more checkpoint, as the JAX two-level
scan does.  Every setting gives the same numbers.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as att
from repro_torch.models import common as cm
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
    def __init__(self, cfg: ModelConfig):
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name}: the MoE layers are not ported yet; see "
                f"ROADMAP.md")
        super().__init__(cfg)

    # ------------------------------------------------------------ params
    def _dense_layer_defs(self):
        cfg = self.cfg
        return {
            "ln1": cm.norm_defs(cfg), "attn": att.attn_defs(cfg),
            "ln2": cm.norm_defs(cfg), "mlp": cm.mlp_defs(cfg),
        }

    def _param_defs_raw(self):
        cfg = self.cfg
        return {
            "embed": cm.embed_defs(cfg),
            "layers": _stack_defs(self._dense_layer_defs(), cfg.n_layers),
            "final_norm": cm.norm_defs(cfg),
        }

    def _constrain_qkv(self, q, k, v):
        """The sharding constraint of the JAX model: the identity on one
        card."""
        return q, k, v

    # ------------------------------------------------------------ layers
    def _attn_block(self, p, x, positions):
        """Pre-norm causal self-attention with residual over (B,S,D);
        returns (x + o, k, v) so a caller can keep the KV cache."""
        cfg = self.cfg
        h = cm.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        q, k, v = att.project_qkv(p["attn"], h, cfg, positions)
        qc, kc, vc = self._constrain_qkv(q, k, v)
        # positions is arange(S) (prefill), the kernel's kv_offset = 0;
        # passing it on would cost a device sync to check
        ctx = att.blocked_attention(
            qc, kc, vc, chunk=cfg.attn_chunk, causal=True)
        return x + att.attn_out(p["attn"], ctx, cfg), k, v

    def _ffn_block(self, p, x):
        cfg = self.cfg
        h = cm.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        return x + cm.mlp(p["mlp"], h), 0.0

    def _layer(self, params, i, x, positions):
        """Layer i of the stack on x (B,S,D): attention and MLP blocks."""
        p = cm.layer_slice(params["layers"], i)
        x, _, _ = self._attn_block(p, x, positions)
        x, _ = self._ffn_block(p, x)
        return x

    # ------------------------------------------------------------- train
    def forward(self, params, tokens):
        """tokens (B,S) -> (final hidden states (B,S,D), aux loss 0.0)."""
        cfg = self.cfg
        x = cm.embed(params["embed"], tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=x.device)
        body = remat(lambda i, h: self._layer(params, i, h, positions), cfg)
        n, blk = cfg.n_layers, cfg.scan_block
        if cfg.scan_layers and blk and n % blk == 0:
            # two-level (sqrt) remat: the outer checkpoint keeps only each
            # group's input; the group's layers are recomputed in backward
            def group(g, h):
                for i in range(g * blk, (g + 1) * blk):
                    h = body(i, h)
                return h
            group_body = remat(group, cfg)
            for g in range(n // blk):
                x = group_body(g, x)
        else:
            for i in range(n):
                x = body(i, x)
        return self._final(params, x)

    def _decode_layer(self, p, x, kc, vc, pos):
        """x (B,1,D); kc/vc (B,Smax,K,h) single-layer cache, written in
        place at pos."""
        cfg = self.cfg
        h = cm.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        positions = torch.full((1,), pos, device=x.device)
        q, k, v = att.project_qkv(p["attn"], h, cfg, positions)
        att.update_cache(kc, k, pos, cfg.cache_update)
        att.update_cache(vc, v, pos, cfg.cache_update)
        ctx = att.decode_attention(q, kc, vc, pos)
        x = x + att.attn_out(p["attn"], ctx, cfg)
        x, _ = self._ffn_block(p, x)
        return x

    # ----------------------------------------------------------- serving
    def cache_struct(self, batch: int, max_len: int):
        cfg = self.cfg
        sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": cm.CacheSpec(sh, cfg.act_dtype),
                "v": cm.CacheSpec(sh, cfg.act_dtype)}

    def decode_step(self, params, cache, token, pos):
        """token (B,), pos int -> (logits (B,Vp), cache updated in place)."""
        cfg = self.cfg
        x = cm.embed(params["embed"], token[:, None], cfg)  # (B,1,D)
        for i in range(cfg.n_layers):
            x = self._decode_layer(cm.layer_slice(params["layers"], i), x,
                                   cache["k"][i], cache["v"][i], pos)
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = cm.logits_last(params["embed"], x[:, 0], cfg)
        return logits, cache

    def prefill(self, params, tokens, max_len: int):
        """tokens (B,S) -> (cache with [0:S] filled, last-token logits)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = cm.embed(params["embed"], tokens, cfg)
        positions = torch.arange(S, device=x.device)
        cache = self.init_cache(B, max(max_len, S))
        for i in range(cfg.n_layers):
            p_l = cm.layer_slice(params["layers"], i)
            x, k, v = self._attn_block(p_l, x, positions)
            x, _ = self._ffn_block(p_l, x)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = cm.logits_last(params["embed"], x[:, -1], cfg)
        return cache, logits
