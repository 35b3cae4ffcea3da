"""Boltzmann chromosome (paper §3.2 + Appendix E): a stateless policy that
directly parameterizes the mapping distribution — per-node prior logits P
and a per-(node, sub-action) temperature T. Sampling softmax(P / T) gives
an action; T is learned by evolution, balancing exploration/exploitation
*per node*. Priors can be (re)seeded from a GNN policy's posterior —
the mixed-population information pathway of Figure 2.

Counterpart of ``src/repro/core/boltzmann.py``, with the same flat
encoding.  Random draws are explicit: a ``torch.Generator`` or a tensor
of standard normal noise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Boltzmann(NamedTuple):
    prior: torch.Tensor    # (..., N, 2, 3) logits
    log_t: torch.Tensor    # (..., N, 2) log temperature


def init_boltzmann(generator: torch.Generator, n_nodes: int,
                   init_action: int = 0) -> Boltzmann:
    """Paper's initial mapping action is 'DRAM' (tier 0 = HBM here)."""
    dev = generator.device
    prior = torch.zeros((n_nodes, 2, 3), device=dev)
    prior[:, :, init_action] = 1.0
    prior = prior + 0.1 * torch.randn(prior.shape, generator=generator,
                                      device=dev)
    return Boltzmann(prior, torch.zeros((n_nodes, 2), device=dev))


def seed_from_logits(logits: torch.Tensor, noise: torch.Tensor,
                     t_init: float = 0.5) -> Boltzmann:
    """Seed the prior from a GNN policy's posterior (Alg 2 lines 16-18).
    ``noise`` holds standard normals shaped like ``logits.shape[:-1]``."""
    log_t = torch.full(noise.shape, math.log(t_init), dtype=torch.float32,
                       device=noise.device)
    return Boltzmann(logits, log_t + 0.1 * noise)


def boltzmann_logits(b: Boltzmann) -> torch.Tensor:
    t = torch.exp(b.log_t)[..., None]
    return b.prior / torch.clamp(t, min=1e-3)


def sample(b: Boltzmann, gumbel_noise: torch.Tensor) -> torch.Tensor:
    """Gumbel-max categorical sample of softmax(prior / T)."""
    return torch.argmax(boltzmann_logits(b) + gumbel_noise,
                        dim=-1).to(torch.int32)


def greedy(b: Boltzmann) -> torch.Tensor:
    return torch.argmax(b.prior, dim=-1).to(torch.int32)


# ---------------------------------------------------------- flat encoding
def prior_size(n_nodes: int) -> int:
    return n_nodes * 2 * 3


def flat_size(n_nodes: int) -> int:
    return prior_size(n_nodes) + n_nodes * 2


def to_flat(prior: torch.Tensor, log_t: torch.Tensor) -> torch.Tensor:
    """(..., N, 2, 3) + (..., N, 2) -> (..., flat_size)."""
    lead = prior.shape[:-3]
    return torch.cat([prior.reshape(lead + (-1,)),
                      log_t.reshape(lead + (-1,))], dim=-1)


def from_flat(vec: torch.Tensor, n_nodes: int) -> Boltzmann:
    """(..., flat_size) -> Boltzmann with (..., N, 2, 3) / (..., N, 2)."""
    lead = vec.shape[:-1]
    n_p = prior_size(n_nodes)
    return Boltzmann(vec[..., :n_p].reshape(lead + (n_nodes, 2, 3)),
                     vec[..., n_p:].reshape(lead + (n_nodes, 2)))
