"""Extract a placement WorkloadGraph from any assigned architecture config
at a given run shape — the bridge that makes the paper's technique a
first-class framework feature (--arch x --shape => EGRL placement plan).

Semantics per shape kind:
- train / prefill: one forward over (B, S) tokens; activations are
  (B, S, ...) tensors.
- decode: one token step; activations are (B, 1, ...) but each attention
  layer gains a KV-CACHE node — a large placeable tensor read in full every
  step (the dominant decode placement decision).

MoE expert banks are single nodes with weight_access_frac = top_k/E
(expected streamed fraction under load balance; DESIGN.md §6). Weight-tied
blocks (zamba2 shared attention) carry their bytes on the first
application only.

Copied from ``src/repro/graphs/extract.py`` (numpy only).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeCfg,
                                      supports_shape)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.graphs.graph import Node, WorkloadGraph
from repro_torch.graphs.zoo import PAPER_WORKLOADS


class _B:
    def __init__(self):
        self.nodes: List[Node] = []
        self.edges: List[Tuple[int, int]] = []

    def add(self, node: Node, srcs) -> int:
        i = len(self.nodes)
        self.nodes.append(node)
        for s in srcs:
            self.edges.append((s, i))
        return i


def _attn_nodes(b: _B, cfg: ModelConfig, i: int, S: int, B: int,
                decode: bool, cache_len: int, tied_bytes: bool = True):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wq = 2.0 * D * (H + 2 * K) * hd if tied_bytes else 0.0
    wo = 2.0 * H * hd * D if tied_bytes else 0.0
    s_eff = 1 if decode else S
    i = b.add(Node(op="qkv", weight_bytes=wq, ifm=(s_eff, 1, D),
                   ofm=(s_eff, 1, (H + 2 * K) * hd),
                   flops=2.0 * s_eff * D * (H + 2 * K) * hd, batch=B), [i])
    if decode:
        kvb = 2.0 * B * cache_len * 2 * K * hd
        kv = b.add(Node(op="kv_cache", weight_bytes=kvb, ifm=(cache_len, 1, K * hd),
                        ofm=(1, 1, H * hd), flops=2.0 * cache_len * H * hd * 2,
                        batch=B), [i])
        i = kv
    else:
        i = b.add(Node(op="attn", ifm=(S, 1, H * hd), ofm=(S, 1, H * hd),
                       flops=4.0 * S * S * H * hd, batch=B), [i])
    i = b.add(Node(op="o_proj", weight_bytes=wo, ifm=(s_eff, 1, H * hd),
                   ofm=(s_eff, 1, D), flops=2.0 * s_eff * H * hd * D,
                   batch=B), [i])
    return i


def _mlp_nodes(b: _B, cfg: ModelConfig, i: int, S: int, B: int, decode: bool):
    D, F = cfg.d_model, cfg.d_ff
    s_eff = 1 if decode else S
    i = b.add(Node(op="mlp", weight_bytes=2.0 * 2 * D * F, ifm=(s_eff, 1, D),
                   ofm=(s_eff, 1, F), flops=4.0 * s_eff * D * F, batch=B), [i])
    i = b.add(Node(op="mlp", weight_bytes=2.0 * F * D, ifm=(s_eff, 1, F),
                   ofm=(s_eff, 1, D), flops=2.0 * s_eff * F * D, batch=B), [i])
    return i


def _moe_nodes(b: _B, cfg: ModelConfig, i: int, S: int, B: int, decode: bool):
    m = cfg.moe
    D, Fe, E, k = cfg.d_model, m.d_ff_expert, m.n_experts, m.top_k
    s_eff = 1 if decode else S
    i = b.add(Node(op="moe_router", weight_bytes=2.0 * D * E,
                   ifm=(s_eff, 1, D), ofm=(s_eff, 1, E),
                   flops=2.0 * s_eff * D * E, batch=B), [i])
    i = b.add(Node(op="expert_bank", weight_bytes=2.0 * E * 3 * D * Fe,
                   ifm=(s_eff, 1, D), ofm=(s_eff, 1, D),
                   flops=6.0 * s_eff * D * Fe * k, batch=B,
                   weight_access_frac=min(1.0, k / E * max(1, s_eff * B / 64)),
                   groups=E), [i])
    if m.shared_expert_ff:
        i = b.add(Node(op="mlp", weight_bytes=2.0 * 3 * D * m.shared_expert_ff,
                       ifm=(s_eff, 1, D), ofm=(s_eff, 1, D),
                       flops=6.0 * s_eff * D * m.shared_expert_ff, batch=B), [i])
    return i


def _ssm_nodes(b: _B, cfg: ModelConfig, i: int, S: int, B: int, decode: bool,
               tied_bytes: bool = True):
    s = cfg.ssm
    D = cfg.d_model
    d_in = D * s.expand
    H = d_in // s.head_dim
    s_eff = 1 if decode else S
    w_in = 2.0 * D * (2 * d_in + 2 * s.d_state + H) if tied_bytes else 0.0
    i = b.add(Node(op="conv1d", weight_bytes=w_in, ifm=(s_eff, 1, D),
                   ofm=(s_eff, 1, d_in), flops=2.0 * s_eff * D * 2 * d_in,
                   kernel=(s.conv_width, 1), batch=B), [i])
    i = b.add(Node(op="ssm", ifm=(s_eff, 1, d_in), ofm=(s_eff, 1, d_in),
                   flops=6.0 * s_eff * H * s.head_dim * s.d_state, batch=B,
                   groups=H), [i])
    i = b.add(Node(op="o_proj", weight_bytes=2.0 * d_in * D if tied_bytes else 0.0,
                   ifm=(s_eff, 1, d_in), ofm=(s_eff, 1, D),
                   flops=2.0 * s_eff * d_in * D, batch=B), [i])
    return i


def extract_for(arch: str, shape_name: str) -> WorkloadGraph:
    """Resolve (arch, shape) request strings to a WorkloadGraph — the
    request-facing bridge the placement service and the CLIs share.

    ``arch`` is a registry id (``configs/registry.py``) or a paper
    workload name (``graphs/zoo.py`` ``PAPER_WORKLOADS``); ``shape_name`` is
    a SHAPES key (ignored for paper workloads, which carry their own
    fixed shape).  Raises ``KeyError`` naming the unknown id — the
    fail-loud surface ``serving/placement_service.py`` converts into a
    failed PlacementResult.  Deterministic: the same request always
    yields the same graph (and so the same canonical hash).
    """
    if arch in PAPER_WORKLOADS:
        return PAPER_WORKLOADS[arch]()
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{', '.join(tuple(ARCH_IDS) + tuple(PAPER_WORKLOADS))}")
    if shape_name not in SHAPES:
        raise KeyError(f"unknown shape {shape_name!r}; known: "
                       f"{', '.join(SHAPES)}")
    cfg = get_config(arch)
    ok, why = supports_shape(cfg, SHAPES[shape_name])
    if not ok:
        raise KeyError(f"{arch} does not support {shape_name}: {why}")
    return extract_graph(cfg, SHAPES[shape_name])


def extract_graph(cfg: ModelConfig, shape: ShapeCfg, *,
                  mesh_data: int = 16, mesh_model: int = 16) -> WorkloadGraph:
    """Graph of ONE chip's SPMD shard (DESIGN.md §2): weights divided by the
    tensor-parallel degree (x FSDP for train/prefill), activations by the
    batch sharding, KV caches by batch x model. EGRL then places the
    per-chip tensors into that chip's HBM/CMEM/VMEM — every chip is
    identical under SPMD, so one plan serves the whole mesh."""
    g = _extract_unsharded(cfg, shape)
    kind = shape.kind
    w_div = float(mesh_model * (mesh_data if kind != "decode" else 1))
    b_div = min(shape.global_batch, mesh_data)
    a_div = float(b_div)
    kv_div = float(b_div * mesh_model)
    for nd in g.nodes:
        if nd.op == "kv_cache":
            nd.weight_bytes /= kv_div
            nd.flops /= kv_div
        else:
            nd.weight_bytes /= w_div
            nd.flops /= a_div * (mesh_model if kind != "decode" else 1)
        nd.batch = max(1, int(nd.batch // b_div))
    return g


def _extract_unsharded(cfg: ModelConfig, shape: ShapeCfg) -> WorkloadGraph:
    b = _B()
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    s_eff = 1 if decode else S
    D, Vp = cfg.d_model, cfg.vocab_padded

    i = b.add(Node(op="embed", weight_bytes=2.0 * Vp * D, ifm=(s_eff, 1, 1),
                   ofm=(s_eff, 1, D), flops=float(s_eff * D), batch=B,
                   weight_access_frac=min(1.0, s_eff * B / Vp)), [])

    if cfg.family in ("dense", "moe", "vlm"):
        for layer in range(cfg.n_layers):
            prev = i
            i = _attn_nodes(b, cfg, i, S, B, decode, S)
            use_moe = cfg.moe is not None and (layer % cfg.moe.every
                                               == cfg.moe.every - 1)
            i = (_moe_nodes if use_moe else _mlp_nodes)(b, cfg, i, S, B, decode)
            b.edges.append((prev, i))  # residual
    elif cfg.family == "ssm":
        for layer in range(cfg.n_layers):
            prev = i
            i = _ssm_nodes(b, cfg, i, S, B, decode)
            b.edges.append((prev, i))
    elif cfg.family == "hybrid":
        k = cfg.shared_attn_every
        for layer in range(cfg.n_layers):
            prev = i
            i = _ssm_nodes(b, cfg, i, S, B, decode)
            b.edges.append((prev, i))
            if layer % k == k - 1:
                first = layer == k - 1
                i = _attn_nodes(b, cfg, i, S, B, decode, S, tied_bytes=first)
                i = _mlp_nodes(b, cfg, i, S, B, decode) if first else \
                    _mlp_tied(b, cfg, i, S, B, decode)
    elif cfg.family == "encdec":
        enc_i = i
        for _ in range(cfg.enc_layers):  # encoder always runs full length
            prev = enc_i
            enc_i = _attn_nodes(b, cfg, enc_i, S, B, decode=False, cache_len=S)
            enc_i = _mlp_nodes(b, cfg, enc_i, S, B, decode=False)
            b.edges.append((prev, enc_i))
        i = enc_i
        for _ in range(cfg.dec_layers):
            prev = i
            i = _attn_nodes(b, cfg, i, S, B, decode, S)
            # cross attention reads encoder memory
            i = b.add(Node(op="cross_attn",
                           weight_bytes=2.0 * D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim,
                           ifm=(S, 1, D), ofm=(s_eff, 1, D),
                           flops=4.0 * s_eff * S * D, batch=B), [i, enc_i])
            i = _mlp_nodes(b, cfg, i, S, B, decode)
            b.edges.append((prev, i))
    else:
        raise ValueError(cfg.family)

    b.add(Node(op="lm_head", weight_bytes=0.0 if cfg.tie_embeddings
               else 2.0 * D * Vp, ifm=(s_eff, 1, D), ofm=(s_eff, 1, Vp),
               flops=2.0 * s_eff * D * Vp, batch=B), [i])
    g = WorkloadGraph(f"{cfg.name}__{shape.name}", b.nodes, b.edges)
    g.validate()
    return g


def _mlp_tied(b: _B, cfg: ModelConfig, i: int, S: int, B: int, decode: bool):
    D, F = cfg.d_model, cfg.d_ff
    s_eff = 1 if decode else S
    i = b.add(Node(op="mlp", weight_bytes=0.0, ifm=(s_eff, 1, D),
                   ofm=(s_eff, 1, F), flops=4.0 * s_eff * D * F, batch=B), [i])
    i = b.add(Node(op="mlp", weight_bytes=0.0, ifm=(s_eff, 1, F),
                   ofm=(s_eff, 1, D), flops=2.0 * s_eff * F * D, batch=B), [i])
    return i
