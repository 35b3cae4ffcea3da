"""Encoder-decoder transformer (the seamless-m4t backbone): training
forward and loss, prefill and decode.

Copied from ``src/repro/models/encdec.py``.  The speech frontend is a
stub, as in the JAX package: the encoder takes precomputed frame
embeddings (B, Se, D).  Encoder layers: non-causal
self-attention with RoPE, SwiGLU MLP.  Decoder layers: causal
self-attention with RoPE, non-causal cross-attention over the encoder
memory (no RoPE, Sq != Sk), SwiGLU MLP.  Every prefill and training
attention goes through ``blocked_attention`` (the flash kernels on
CUDA); decode is ``decode_attention`` over the self cache and over the
cross cache, plain torch ops as in the JAX package.  Each encoder and
decoder layer is one ``remat`` unit, as JAX's ``_remat`` body; under
FSDP its slice is gathered inside the unit (``LMBase.layer``), so again
in its recompute.

Under a plan that splits "model" (JAX ``:60-119``) every attention and
MLP goes through ``TransformerLM``'s split blocks (``self._tf``, built
with the plan): the encoder's self-attention and MLP, the decoder's
self-attention, cross-attention and MLP.  The cross-attention's k / v
come from the encoder memory (whole on every rank, gathered on S under
Megatron-SP) through this rank's kv heads of wk / wv; the embedding and
the loss are vocab-parallel, as in the dense family.  Serving: the self
and cross caches both take the plan's cache spec; a decode step's
cross-attention runs over the whole encoder memory through the rank's
heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel as par
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models.transformer import TransformerLM, _stack_defs, remat


class EncDecLM(cm.LMBase):
    def __init__(self, cfg: ModelConfig, plan=None):
        assert cfg.enc_layers and cfg.dec_layers
        super().__init__(cfg, plan)
        self._tf = TransformerLM(cfg, plan)

    def _enc_layer_defs(self):
        cfg = self.cfg
        return {"ln1": cm.norm_defs(cfg), "attn": att.attn_defs(cfg),
                "ln2": cm.norm_defs(cfg), "mlp": cm.mlp_defs(cfg)}

    def _dec_layer_defs(self):
        cfg = self.cfg
        return {"ln1": cm.norm_defs(cfg), "attn": att.attn_defs(cfg),
                "lnx": cm.norm_defs(cfg), "xattn": att.attn_defs(cfg),
                "ln2": cm.norm_defs(cfg), "mlp": cm.mlp_defs(cfg)}

    def _param_defs_raw(self):
        cfg = self.cfg
        return {
            "embed": cm.embed_defs(cfg),
            "enc": _stack_defs(self._enc_layer_defs(), cfg.enc_layers),
            "dec": _stack_defs(self._dec_layer_defs(), cfg.dec_layers),
            "enc_norm": cm.norm_defs(cfg),
            "final_norm": cm.norm_defs(cfg),
        }

    # ----------------------------------------------------------- encoder
    def _enc_layer(self, p, h, positions):
        h, _, _ = self._tf._attn_block(p, h, positions, causal=False)
        return self._tf._ffn_block(p, h)[0]

    def encode(self, params, enc_emb):
        """enc_emb (B,Se,D) precomputed frame embeddings (frontend stub)
        -> encoder memory (B,Se,D) in the activation dtype."""
        cfg = self.cfg
        params = self.view(params)
        x = enc_emb.to(cfg.act_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        if self.tp is not None and self.tp.seq:
            x = x[:, par.seq_rows(x.shape[1], self.tp.mesh)]
        body = remat(lambda i, h: self._enc_layer(
            self.layer(params, "enc", i), h, positions), cfg)
        for i in range(cfg.enc_layers):
            x = body(i, x)
        return cm.rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)

    # ----------------------------------------------------- cross-attention
    def _cross_kv(self, p_x, enc_out):
        """Cross-attention keys and values (B,Se,K,h) of the memory."""
        return att._proj(enc_out, p_x["wk"]), att._proj(enc_out, p_x["wv"])

    def _cross_q(self, p_x, h):
        cfg = self.cfg
        B, St = h.shape[:2]
        return att._proj(h, p_x["wq"]).reshape(B, St, cfg.n_kv_heads,
                                               cfg.q_per_kv, cfg.head_dim)

    def _cross_attend(self, p_x, h, k, v):
        """h (B,St,D) over the memory's k, v: non-causal, no RoPE."""
        cfg = self.cfg
        ctx = att.blocked_attention(self._cross_q(p_x, h), k, v,
                                    chunk=cfg.attn_chunk, causal=False)
        return att.attn_out(p_x, ctx, cfg)

    # ------------------------------------------------------------- train
    def _dec_layer(self, p, h, enc_out, positions):
        cfg = self.cfg
        h, _, _ = self._tf._attn_block(p, h, positions)
        hh = cm.rms_norm(h, p["lnx"]["scale"], cfg.norm_eps)
        if self.tp is None:
            xk, xv = self._cross_kv(p["xattn"], enc_out)
            h = h + self._cross_attend(p["xattn"], hh, xk, xv)
        else:
            h = h + self._tf._tp_attention(p["xattn"], hh, enc_out,
                                           positions, False, cross=True)[0]
        return self._tf._ffn_block(p, h)[0]

    def forward(self, params, batch):
        """batch {tokens (B,St), enc_emb (B,Se,D)} -> (final hidden
        states (B,St,D), aux loss 0.0)."""
        cfg = self.cfg
        params = self.view(params)
        enc_out = self.encode(params, batch["enc_emb"])
        tokens = batch["tokens"]
        x = self._embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        body = remat(lambda i, h, mem: self._dec_layer(
            self.layer(params, "dec", i), h, mem, positions), cfg)
        for i in range(cfg.dec_layers):
            x = body(i, x, enc_out)
        return self._final(params, x)

    def loss(self, params, batch):
        """batch: {tokens, labels (B,St)[, mask], enc_emb (B,Se,D)} ->
        (loss, metrics {ce, aux, tokens})."""
        params = self.view(params)
        h, aux = self.forward(params, batch)
        ce, cnt = self._xent(params["embed"], h, batch["labels"],
                             batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux, "tokens": cnt}

    # ----------------------------------------------------------- serving
    def cache_struct(self, batch: int, max_len: int, enc_len: int = None):
        cfg = self.cfg
        enc_len = enc_len or max_len
        sh_self = (cfg.dec_layers, batch, max_len, cfg.n_kv_heads,
                   cfg.head_dim)
        sh_cross = (cfg.dec_layers, batch, enc_len, cfg.n_kv_heads,
                    cfg.head_dim)
        f = lambda sh: cm.CacheSpec(sh, cfg.act_dtype)  # noqa: E731
        return {"k": f(sh_self), "v": f(sh_self),
                "xk": f(sh_cross), "xv": f(sh_cross)}

    def decode_step(self, params, cache, token, pos):
        """token (B,), pos int -> (logits (B,Vp), cache: the self cache
        updated in place at pos, the cross cache as it was).  Under a
        plan: this rank's rows, heads and cache blocks; cross-attention
        over the whole encoder memory through the rank's heads."""
        cfg = self.cfg
        tp = self.tp_whole
        params = self.view(params)
        x = self._embed(params["embed"], token[:, None], tp)
        cut = self.cache_cut
        Se = cache["xk"].shape[2] * (1 if cut is None else cut.n)
        for i in range(cfg.dec_layers):
            p = self.layer(params, "dec", i)
            x = self._tf._decode_attn(p, x, cache["k"][i], cache["v"][i],
                                      pos, tp)
            # cross-attention over the full encoder memory
            hh = cm.rms_norm(x, p["lnx"]["scale"], cfg.norm_eps)
            if tp is not None:
                hh = tp.enter(hh)
            x = x + self._tf._decode_heads(
                p["xattn"], att._proj(hh, p["xattn"]["wq"]), cache["xk"][i],
                cache["xv"][i], Se - 1, tp)
            x, _ = self._tf._ffn_block(p, x, tp=tp)
        x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._logits_last(params["embed"], x[:, 0], tp), cache

    def prefill(self, params, enc_emb, max_len: int):
        """enc_emb (B,Se,D) -> (cache: the cross keys and values of each
        decoder layer, the self cache empty but for BOS at 0; BOS
        logits (B,Vp)).  Under a plan: this rank's rows, the encoder
        split as in training, each cache this rank's block."""
        cfg = self.cfg
        params = self.view(params)
        enc_out = self.encode(params, enc_emb)
        if self.tp is not None:
            enc_out = self.tp.enter(enc_out)    # whole under Megatron-SP
        B = enc_out.shape[0]
        cache = self.init_cache(B * self.batch_shards, max_len,
                                enc_len=enc_out.shape[1])
        cut = self.cache_cut
        for i in range(cfg.dec_layers):
            xk, xv = self._cross_kv(
                self.layer(params, "dec", i)["xattn"], enc_out)
            att.fill_cache(cache["xk"][i], xk, cut)
            att.fill_cache(cache["xv"][i], xv, cut)
        bos = torch.zeros((B,), dtype=torch.long, device=enc_out.device)
        logits, cache = self.decode_step(params, cache, bos, 0)
        return cache, logits
