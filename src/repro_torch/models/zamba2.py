"""Zamba2-style hybrid: Mamba2 backbone + one weight-TIED transformer
block applied after every `shared_attn_every` mamba layers.

Copied from ``src/repro/models/zamba2.py`` (training forward and loss,
prefill and decode).  Layers are grouped as (G groups of [k mamba
layers + shared attn/mlp block]) + a tail of (n_layers % k) mamba
layers; the parameters keep the JAX layout, ``groups`` stacked (G, k,
...) and ``tail`` (tail, ...), and each shared-block application has its
own KV-cache slice.  The training forward checkpoints each group (its k
mamba layers and the shared block, as JAX's ``_remat`` of
``_group_fwd``) and runs the tail outside any checkpoint; the shared
block's gradients sum over its G uses.  Under FSDP each mamba layer's
slice is gathered where it runs (``LMBase.layer``): inside its group's
checkpoint, so again in the recompute; the tail's outside any, so its
few gathered layers are saved for the backward, as JAX keeps an
unscanned tail's.  The shared block is gathered once a forward
(``LMBase.view``) and its gradient, summed over the G uses, reduce-
scattered once.  Under a plan that splits
"model", the mamba layers run on this rank's heads where the plan splits
them, else whole on every rank (``mamba2.mamba_layer``), and the shared
block through
``TransformerLM``'s split attention and MLP (``self._tf``, built with
the plan); serving keeps the rank's SSM heads' caches and its block of
the shared block's KV cache (cut on S over "data" at a batch of 1, as
JAX's long_500k cell lays it out).

Simplification vs the released checkpoints, as in the JAX package: the
shared block consumes the residual stream directly (no
concat-with-embedding re-projection, no per-invocation LoRA deltas).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models.mamba2 import (decode_layer, mamba_defs,
                                       mamba_layer, ssm_cache_struct)
from repro_torch.models.transformer import (TransformerLM, _stack_defs,
                                           remat)


class Zamba2LM(cm.LMBase):
    def __init__(self, cfg: ModelConfig, plan=None):
        assert cfg.shared_attn_every > 0 and cfg.ssm is not None
        super().__init__(cfg, plan)
        self.k = cfg.shared_attn_every
        self.G = cfg.n_layers // self.k
        self.tail = cfg.n_layers % self.k
        # reuse transformer attention/mlp machinery for the shared block,
        # split over "model" as the plan says
        self._tf = TransformerLM(cfg, plan)

    # ------------------------------------------------------------ params
    def _param_defs_raw(self):
        cfg = self.cfg
        md = mamba_defs(cfg)
        d = {
            "embed": cm.embed_defs(cfg),
            "groups": _stack_defs(_stack_defs(md, self.k), self.G),
            "shared": {
                "ln1": cm.norm_defs(cfg), "attn": att.attn_defs(cfg),
                "ln2": cm.norm_defs(cfg), "mlp": cm.mlp_defs(cfg),
            },
            "final_norm": cm.norm_defs(cfg),
        }
        if self.tail:
            d["tail"] = _stack_defs(md, self.tail)
        return d

    def _mamba_layer(self, params, i):
        """The parameters of mamba layer ``i`` (depth order): of group
        i // k, or of the tail."""
        if i < self.G * self.k:
            return self.layer(params, "groups", i // self.k, i % self.k)
        return self.layer(params, "tail", i - self.G * self.k)

    def _mamba_layers(self, params):
        """(depth index, layer params) for the n_layers mamba layers in
        depth order, a layer at a time, with the shared block due after
        each group."""
        for i in range(self.cfg.n_layers):
            yield i, self._mamba_layer(params, i)

    # ------------------------------------------------------------- train
    def _group_fwd(self, params, g, x, positions):
        """Group g on x (B,S,D): its k mamba layers, then the shared
        attention and MLP block."""
        cfg, shared = self.cfg, params["shared"]
        for i in range(g * self.k, (g + 1) * self.k):
            x, _ = mamba_layer(self, self._mamba_layer(params, i), x)
        x, _, _ = self._tf._attn_block(shared, x, positions)
        x, _ = self._tf._ffn_block(shared, x)
        return x

    def forward(self, params, tokens):
        """tokens (B,S) -> (final hidden states (B,S,D), aux loss 0.0)."""
        cfg = self.cfg
        params = self.view(params)
        x = self._embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        body = remat(lambda g, h: self._group_fwd(params, g, h, positions),
                     cfg)
        for g in range(self.G):
            x = body(g, x)
        for i in range(self.G * self.k, cfg.n_layers):
            x, _ = mamba_layer(self, self._mamba_layer(params, i), x)
        return self._final(params, x)

    # ----------------------------------------------------------- serving
    def cache_struct(self, batch: int, max_len: int):
        cfg = self.cfg
        sh = (self.G, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {**ssm_cache_struct(cfg, batch),
                "attn_k": cm.CacheSpec(sh, cfg.act_dtype),
                "attn_v": cm.CacheSpec(sh, cfg.act_dtype)}

    def decode_step(self, params, cache, token, pos):
        """token (B,), pos int -> (logits (B,Vp), cache updated in place).
        Under a plan: this rank's rows, SSM heads and block of the shared
        block's cache."""
        cfg = self.cfg
        tp = self.tp_whole
        params = self.view(params)
        x = self._embed(params["embed"], token[:, None], tp)
        shared = params["shared"]
        for i, p_l in self._mamba_layers(params):
            x = decode_layer(self, p_l, x, cache, i, tp)
            if i < self.G * self.k and (i + 1) % self.k == 0:
                g = i // self.k
                x = self._tf._decode_layer(shared, x, cache["attn_k"][g],
                                           cache["attn_v"][g], pos, tp=tp)
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._logits_last(params["embed"], x[:, 0], tp), cache

    def prefill(self, params, tokens, max_len: int):
        cfg = self.cfg
        B, S = tokens.shape
        params = self.view(params)
        x = self._embed(params["embed"], tokens)
        positions = torch.arange(S, device=x.device)
        shared = params["shared"]
        attn = self.local_cache_struct(B * self.batch_shards,
                                       max(max_len, S))["attn_k"]
        ks = torch.zeros(attn.shape, dtype=attn.dtype, device=x.device)
        vs = torch.zeros_like(ks)
        cut = self.cache_cut
        tails, states = [], []
        for i, p_l in self._mamba_layers(params):
            x, (t3, st) = mamba_layer(self, p_l, x, return_state=True)
            tails.append(t3)
            states.append(st)
            if i < self.G * self.k and (i + 1) % self.k == 0:
                # shared attention over the full prefix, keep kv
                g = i // self.k
                x, k, v = self._tf._attn_block(shared, x, positions)
                att.fill_cache(ks[g], k, cut)
                att.fill_cache(vs[g], v, cut)
                x, _ = self._tf._ffn_block(shared, x)
        cache = {"conv_x": torch.stack([t[0] for t in tails]),
                 "conv_B": torch.stack([t[1] for t in tails]),
                 "conv_C": torch.stack([t[2] for t in tails]),
                 "state": torch.stack(states),
                 "attn_k": ks, "attn_v": vs}
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return cache, self._logits_last(params["embed"], self._last_row(x))
