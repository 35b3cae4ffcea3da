"""Graph U-Net policy (Gao & Ji 2019) in PyTorch, per the paper's §3.2:
graph attention levels around two gPool/gUnpool steps, hidden 128,
depth 4, 4 heads; per node two 3-way categorical sub-actions (weight
tier, activation tier).

Counterpart of ``src/repro/core/gnn.py``.  The JAX package vmaps one
genome's forward over the population; here the population axis P is a
batch axis of every tensor, and each attention level is ONE ``gat_mp``
call over all P genomes.  Level 0 shares one adjacency mask (passed
with a leading 1, never expanded); from level 1 on every genome pooled
its own node set, so each has its own mask.  The padded multi-graph
forwards (``population_logits_zoo`` and its bucketed forms) batch P
genomes x G graphs the same way, level 0 reading the G graph masks
shared by the P genomes (``gat_mp``'s ``rep`` form).

The forward is differentiable with respect to a flat genome that
requires grad (the SAC actor): through ``gat_mp``'s autograd.Function,
the gathers and scatters of ``_pool`` / ``_unpool``, and the sorted
pool scores that gate the kept rows (JAX's ``top_k`` values carry
gradient the same way).  A population without grad builds no autograd
graph.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import gat_tune
from repro_torch.core import params as P_
from repro_torch.kernels.gat_mp import ops as gat_ops

HIDDEN, DEPTH, HEADS = P_.HIDDEN, P_.DEPTH, P_.HEADS
N_SUB, N_TIER = P_.N_SUB, P_.N_TIER


def _gat(p: Dict[str, torch.Tensor], level: int, h: torch.Tensor,
         adj: torch.Tensor, rep: int = 1) -> torch.Tensor:
    """Multi-head graph attention with residual.  h (B, N, D); the
    weights hold 1 set (shared by the batch), B sets, or P sets each
    over G = B / P consecutive batch elements (a genome over a bucket's
    graphs, b = p G + g).  adj (G', N, N) bool, element b reading mask
    (b // rep) % G' (``gat_mp``).  The kernels' block shapes are
    resolved on the first call of a launch key (``core/gat_tune.py``
    ``autotune``; JAX resolves its lowering in ``resolve_backend``)."""
    B, N, D = h.shape
    w, b = p[f"gat{level}.w"], p[f"gat{level}.b"]
    n_w = w.shape[0]
    hp = h.view(n_w, -1, D) if 1 < n_w < B else h       # (P, G N, D)
    z = torch.matmul(hp, w)
    zh = z.view(z.shape[0], -1, HEADS, D // HEADS)
    e_src = torch.einsum("pnhd,phd->pnh", zh, p[f"gat{level}.a_src"])
    e_dst = torch.einsum("pnhd,phd->pnh", zh, p[f"gat{level}.a_dst"])
    gat_tune.autotune(N, D, HEADS, z.dtype, batch=B, masks=adj.shape[0],
                      device=z.device)
    out, _, _ = gat_ops.gat_mp(z.view(B, N, D),
                               e_src.reshape(B, N, HEADS).contiguous(),
                               e_dst.reshape(B, N, HEADS).contiguous(),
                               adj, rep)
    return F.elu(out.view(hp.shape) + b[:, None, :]).view(B, N, D) + h


def _pool(score_w: torch.Tensor, h: torch.Tensor, adj: torch.Tensor,
          k: int):
    """gPool: keep each genome's top-k nodes by learned score.  Ties go
    to the lower index, as ``jax.lax.top_k`` breaks them (tanh saturates
    to exactly +-1.0, so ties happen).  Returns (h_k (P, k, D),
    adj_k (P, k, k), idx (P, k))."""
    P, N, D = h.shape
    norm = torch.linalg.vector_norm(score_w, dim=-1)               # (P,)
    raw = torch.matmul(h, score_w[:, :, None])[..., 0]             # (P, N)
    score = torch.tanh(raw / (norm + 1e-6)[:, None])
    val, idx = torch.sort(score, dim=1, descending=True, stable=True)
    val, idx = val[:, :k], idx[:, :k]
    h_k = torch.gather(h, 1, idx[:, :, None].expand(P, k, D)) * val[:, :, None]
    rows = torch.gather(adj.expand(P, N, N), 1,
                        idx[:, :, None].expand(P, k, N))
    adj_k = torch.gather(rows, 2, idx[:, None, :].expand(P, k, k))
    return h_k, adj_k, idx


def _unpool(h_small: torch.Tensor, idx: torch.Tensor, n: int,
            h_skip: torch.Tensor) -> torch.Tensor:
    """Scatter the pooled rows back to their nodes, then the skip add."""
    P, k, D = h_small.shape
    out = torch.zeros((P, n, D), dtype=h_small.dtype, device=h_small.device)
    out = out.scatter(1, idx[:, :, None].expand(P, k, D), h_small)
    return out + h_skip


def population_forward(pop: torch.Tensor, feats: torch.Tensor,
                       adj: torch.Tensor
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """pop (P, V) flat genomes, feats (N, F), adj (N, N) (bool mask, or
    the row-normalized float adjacency) -> (logits (P, N, 2, 3), the
    pooled index sets (i1 (P, N//2), i2 (P, N//4)))."""
    p = P_.unflatten(pop, P_.gnn_spec(feats.shape[1]))
    N = feats.shape[0]
    mask = (adj if adj.dtype == torch.bool else adj > 0)[None]   # (1, N, N)
    k1, k2 = max(2, N // 2), max(2, N // 4)
    h = torch.tanh(torch.matmul(feats, p["inp"]))                 # (P, N, D)
    h = _gat(p, 0, h, mask)                                       # level 0
    h1, a1, i1 = _pool(p["pool1"], h, mask, k1)                   # down 1
    h1 = _gat(p, 1, h1, a1)
    h2, a2, i2 = _pool(p["pool2"], h1, a1, k2)                    # down 2
    h2 = _gat(p, 2, h2, a2)
    h1u = _unpool(h2, i2, k1, h1)                                 # up 1
    h1u = _gat(p, 3, h1u, a1)
    hu = _unpool(h1u, i1, N, h)                                   # up 2
    z = F.elu(torch.matmul(hu, p["out1"]) + p["out_b1"][:, None, :])
    logits = torch.matmul(z, p["out2"]).view(pop.shape[0], N, N_SUB, N_TIER)
    return logits, (i1, i2)


def population_logits(pop: torch.Tensor, feats: torch.Tensor,
                      adj: torch.Tensor) -> torch.Tensor:
    """Stacked-population forward: (P, V) flat genomes -> (P, N, 2, 3)."""
    return population_forward(pop, feats, adj)[0]


def gnn_forward(vec: torch.Tensor, feats: torch.Tensor,
                adj: torch.Tensor) -> torch.Tensor:
    """One flat (V,) genome -> (N, 2, 3) logits."""
    return population_logits(vec[None], feats, adj)[0]


# ------------------------------------------------- padded multi-graph path
def _pool_masked(score_w: torch.Tensor, h: torch.Tensor, adj: torch.Tensor,
                 live: torch.Tensor, k_shared: int, k_real: torch.Tensor,
                 graph_of: torch.Tensor = None):
    """gPool over padded graphs: the top ``k_shared`` slots of each row
    by score with dead slots scoring -inf (ties to the lower index),
    then only the first ``k_real`` kept live; the other slots are zeroed
    and disconnected.  score_w (B, D); h (B, N, D); adj (G, N, N) bool,
    row b's mask adj[graph_of[b]] (default: adj[b]); live (B, N) f32;
    k_real (B,).  Returns (h_k (B, k, D), adj_k (B, k, k), idx (B, k),
    keep (B, k) f32)."""
    B, N, D = h.shape
    k = k_shared
    norm = torch.linalg.vector_norm(score_w, dim=-1)               # (B,)
    raw = torch.matmul(h, score_w[:, :, None])[..., 0]             # (B, N)
    score = torch.tanh(raw / (norm + 1e-6)[:, None])
    score = torch.where(live > 0, score, float("-inf"))
    val, idx = torch.sort(score, dim=1, descending=True, stable=True)
    val, idx = val[:, :k], idx[:, :k]
    keep = ((torch.arange(k, device=h.device) < k_real[:, None])
            & torch.isfinite(val)).to(h.dtype)
    gate = torch.where(keep > 0, val, 0.0)
    h_k = torch.where(keep[..., None] > 0,
                      torch.gather(h, 1, idx[:, :, None].expand(B, k, D))
                      * gate[..., None], 0.0)
    g = torch.arange(B, device=h.device) if graph_of is None else graph_of
    rows = adj[g[:, None], idx]                                    # (B, k, N)
    adj_k = torch.gather(rows, 2, idx[:, None, :].expand(B, k, k))
    adj_k = adj_k & (keep[:, :, None] * keep[:, None, :] > 0)
    return h_k, adj_k, idx, keep


def population_logits_zoo(pop: torch.Tensor, feats: torch.Tensor,
                          adj: torch.Tensor, node_mask: torch.Tensor,
                          n_nodes: torch.Tensor) -> torch.Tensor:
    """Stacked-population forward over G padded graphs: pop (P, V),
    feats (G, N_max, F), adj (G, N_max, N_max) (bool mask, or the
    row-normalised float adjacency; padded rows self-loop only),
    node_mask (G, N_max) f32, n_nodes (G,) real counts -> logits
    (P, G, N_max, 2, 3), padded rows 0.

    P x G is the batch axis of every tensor (b = p G + g) and each
    attention level is one ``gat_mp`` call; level 0 reads the G graph
    masks, shared by the P genomes.  Pooling keeps the per-graph
    ``max(2, n // 2)`` / ``max(2, n // 4)`` nodes inside the static
    ``N_max``-derived sizes (``_pool_masked``) and every level re-masks
    its rows, so the real rows are a function of the real subgraph only:
    padding content cannot reach them."""
    P = pop.shape[0]
    G, N, F_ = feats.shape
    B = P * G
    p = P_.unflatten(pop, P_.gnn_spec(F_))
    mask = adj if adj.dtype == torch.bool else adj > 0
    dev = feats.device
    k1s, k2s = max(2, N // 2), max(2, N // 4)
    n = n_nodes.long()
    k1r = torch.clamp(n // 2, min=2).repeat(P)                     # (B,)
    k2r = torch.clamp(n // 4, min=2).repeat(P)
    live = node_mask.to(feats.dtype).repeat(P, 1)                  # (B, N)
    graph_of = torch.arange(B, device=dev) % G

    def per_row(w):                                  # (P, D) -> (B, D)
        return w.repeat_interleave(G, dim=0)

    x = (feats * node_mask[..., None]).reshape(G * N, F_)
    h = torch.tanh(torch.matmul(x, p["inp"])).view(B, N, -1)
    h = h * live[..., None]
    h = _gat(p, 0, h, mask) * live[..., None]                     # level 0
    h1, a1, i1, keep1 = _pool_masked(per_row(p["pool1"]), h, mask, live,
                                     k1s, k1r, graph_of)          # down 1
    h1 = _gat(p, 1, h1, a1) * keep1[..., None]
    h2, a2, i2, keep2 = _pool_masked(per_row(p["pool2"]), h1, a1, keep1,
                                     k2s, k2r)                    # down 2
    h2 = _gat(p, 2, h2, a2) * keep2[..., None]
    h1u = _unpool(h2, i2, k1s, h1)                                # up 1
    h1u = _gat(p, 3, h1u, a1) * keep1[..., None]
    hu = _unpool(h1u, i1, N, h)                                   # up 2
    z = F.elu(torch.matmul(hu.view(P, G * N, -1), p["out1"])
              + p["out_b1"][:, None, :])
    logits = torch.matmul(z, p["out2"]).view(P, G, N, N_SUB, N_TIER)
    return torch.where(node_mask[None, :, :, None, None] > 0, logits, 0.0)


def gnn_forward_zoo(vec: torch.Tensor, feats: torch.Tensor,
                    adj: torch.Tensor, node_mask: torch.Tensor,
                    n_nodes: torch.Tensor) -> torch.Tensor:
    """One flat (V,) genome over G padded graphs -> (G, N_max, 2, 3)."""
    return population_logits_zoo(vec[None], feats, adj, node_mask,
                                 n_nodes)[0]


def gnn_forward_masked(vec: torch.Tensor, feats: torch.Tensor,
                       adj: torch.Tensor, node_mask: torch.Tensor,
                       n) -> torch.Tensor:
    """One flat genome over ONE padded graph: feats (N_max, F), adj
    (N_max, N_max), node_mask (N_max,), n real nodes -> (N_max, 2, 3),
    padded rows 0."""
    n = torch.as_tensor(n, device=feats.device).reshape(1)
    return gnn_forward_zoo(vec, feats[None], adj[None], node_mask[None],
                           n)[0]


def population_logits_bucketed(pop: torch.Tensor, buckets
                               ) -> Tuple[torch.Tensor, ...]:
    """(P, V) genomes over each bucket of a ``BucketedZoo`` (any
    sequence of GraphBatch-shaped batches) -> tuple of
    (P, G_k, N_max_k, 2, 3)."""
    return tuple(population_logits_zoo(pop, b.feats, b.adj, b.node_mask,
                                       b.n_nodes) for b in buckets)


def gnn_forward_bucketed(vec: torch.Tensor, buckets
                         ) -> Tuple[torch.Tensor, ...]:
    """One flat genome over each bucket -> tuple of (G_k, N_max_k, 2, 3)."""
    return tuple(lg[0] for lg in population_logits_bucketed(vec[None],
                                                            buckets))


def entropy_masked(logits: torch.Tensor, node_mask: torch.Tensor
                   ) -> torch.Tensor:
    """``entropy`` over the real rows of padded graphs: logits
    (..., N_max, 2, 3), node_mask (..., N_max) -> (...).  Padded rows
    leave both the sum and the divisor."""
    lp = torch.log_softmax(logits, dim=-1)
    ent = -(torch.exp(lp) * lp).sum(-1)                  # (..., N_max, 2)
    live = node_mask.to(ent.dtype)
    return (ent * live[..., None]).sum(dim=(-2, -1)) / torch.clamp(
        live.sum(-1) * ent.shape[-1], min=1.0)


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def greedy_actions(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_actions(logits: torch.Tensor, gumbel_noise: torch.Tensor
                   ) -> torch.Tensor:
    """Categorical sample per (node, sub-action) as the Gumbel-max
    argmax of ``logits + gumbel_noise`` -- what
    ``jax.random.categorical`` computes from its own Gumbel draws."""
    return torch.argmax(logits + gumbel_noise, dim=-1).to(torch.int32)


def log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Sum of the chosen actions' log-probabilities over (N, 2): a scalar
    for one (N, 2, 3) input, (P,) for a stacked one."""
    lp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(lp, -1, actions.long()[..., None])[..., 0]
    return chosen.sum(dim=(-2, -1))


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean per-node entropy over (N, 2) (Appendix D averages over
    nodes): a scalar for one (N, 2, 3) input, (P,) for a stacked one."""
    lp = torch.log_softmax(logits, dim=-1)
    return -(torch.exp(lp) * lp).sum(-1).mean(dim=(-2, -1))
