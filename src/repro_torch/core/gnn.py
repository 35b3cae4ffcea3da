"""Graph U-Net policy (Gao & Ji 2019) in PyTorch, per the paper's §3.2:
graph attention levels around two gPool/gUnpool steps, hidden 128,
depth 4, 4 heads; per node two 3-way categorical sub-actions (weight
tier, activation tier).

Counterpart of ``src/repro/core/gnn.py``.  The JAX package vmaps one
genome's forward over the population; here the population axis P is a
batch axis of every tensor, and each attention level is ONE ``gat_mp``
call over all P genomes.  Level 0 shares one adjacency mask (passed
with a leading 1, never expanded); from level 1 on every genome pooled
its own node set, so each has its own mask.

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

from repro_torch.core import params as P_
from repro_torch.kernels.gat_mp import ops as gat_ops

HIDDEN, DEPTH, HEADS = P_.HIDDEN, P_.DEPTH, P_.HEADS
N_SUB, N_TIER = P_.N_SUB, P_.N_TIER


def _gat(p: Dict[str, torch.Tensor], level: int, h: torch.Tensor,
         adj: torch.Tensor) -> torch.Tensor:
    """Multi-head graph attention with residual.  h (P, N, D); adj
    (1 or P, N, N) bool."""
    P, N, D = h.shape
    w, b = p[f"gat{level}.w"], p[f"gat{level}.b"]
    z = torch.matmul(h, w)                                   # (P, N, D)
    zh = z.view(P, N, HEADS, D // HEADS)
    e_src = torch.einsum("pnhd,phd->pnh", zh, p[f"gat{level}.a_src"])
    e_dst = torch.einsum("pnhd,phd->pnh", zh, p[f"gat{level}.a_dst"])
    out, _, _ = gat_ops.gat_mp(z, e_src.contiguous(), e_dst.contiguous(),
                               adj)
    return F.elu(out + b[:, None, :]) + h


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
