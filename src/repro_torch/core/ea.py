"""Evolutionary operators over the mixed population (Algorithm 2).

Counterpart of the single-device ``evolve`` of ``src/repro/core/ea.py``
(the unpadded, unsharded branch of ``_evolve_core``): tournament
selection, single-point crossover, GNN->Boltzmann prior seeding and
Gaussian mutation over stacked genomes, with the same fixed encoding
slots and the same elites-first row layout (elites fill the leading
rows in fitness order, row 0 = best).

Every random number the step uses is drawn up front into an
``EvolveDraws`` (``draw_evolve``), and ``evolve`` is a deterministic
function of the populations, their fitness and those draws.  That is
what lets a test hand ``evolve`` the draws the JAX package makes from
its key and compare the two steps row by row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import boltzmann as bz


@dataclasses.dataclass
class GnnDraws:
    """Draws for the n_child = n_g - e_g GNN children."""
    cands: torch.Tensor       # (n_child, k) tournament candidates in [0, n_g)
    mate_idx: torch.Tensor    # (n_child,) elite mates in [0, e_g)
    cross_pt: torch.Tensor    # (n_child,) crossover points in [1, V)
    cross_u: torch.Tensor     # (n_child,) uniform: crossover gate
    super_u: torch.Tensor     # (n_child,) uniform: super-mutation coin
    mut_u: torch.Tensor       # (n_child, V) uniform: mutated-gene mask
    mut_noise: torch.Tensor   # (n_child, V) standard normal
    mut_gate_u: torch.Tensor  # (n_child,) uniform: mutation gate


@dataclasses.dataclass
class BoltzDraws:
    """Draws for the n_child = n_b - e_b Boltzmann children.  The mate
    fields are None when the elite pool is empty."""
    cands: torch.Tensor                  # (n_child, k) in [0, n_b)
    mate_idx: Optional[torch.Tensor]     # (n_child,) in [0, elite pool)
    seed_noise: Optional[torch.Tensor]   # (n_child, N, 2) standard normal
    cross_pt: Optional[torch.Tensor]     # (n_child,) in [1, F)
    cross_u: Optional[torch.Tensor]      # (n_child,) uniform
    prior_noise: torch.Tensor            # (n_child, 6N) standard normal
    prior_u: torch.Tensor                # (n_child, 6N) uniform
    logt_noise: torch.Tensor             # (n_child, 2N) standard normal
    logt_u: torch.Tensor                 # (n_child, 2N) uniform
    mut_gate_u: torch.Tensor             # (n_child,) uniform


@dataclasses.dataclass
class EvolveDraws:
    g: Optional[GnnDraws]
    b: Optional[BoltzDraws]


def elite_pool_size(n_g: int, e_g: int, e_b: int) -> int:
    """Boltzmann children draw mates from the GNN elites too, when there
    are any (Alg 2's cross-type pathway)."""
    return e_g + e_b if (n_g and e_g) else e_b


def draw_evolve(generator: torch.Generator, *, n_g: int, n_b: int, e_g: int,
                e_b: int, genome_size: int, n_nodes: int,
                tournament_k: int) -> EvolveDraws:
    """All random numbers of one ``evolve`` step, from ``generator``."""
    dev = generator.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    g = b = None
    nc = n_g - e_g
    if n_g and nc:
        g = GnnDraws(randint(0, n_g, (nc, tournament_k)),
                     randint(0, e_g, (nc,)), randint(1, genome_size, (nc,)),
                     rand(nc), rand(nc), rand(nc, genome_size),
                     randn(nc, genome_size), rand(nc))
    nc = n_b - e_b
    if n_b and nc:
        n_prior = bz.prior_size(n_nodes)
        pool = elite_pool_size(n_g, e_g, e_b)
        mate = (randint(0, pool, (nc,)), randn(nc, n_nodes, 2),
                randint(1, bz.flat_size(n_nodes), (nc,)), rand(nc)
                ) if pool else (None,) * 4
        b = BoltzDraws(randint(0, n_b, (nc, tournament_k)), *mate,
                       randn(nc, n_prior), rand(nc, n_prior),
                       randn(nc, 2 * n_nodes), rand(nc, 2 * n_nodes),
                       rand(nc))
    return EvolveDraws(g, b)


def tournament_indices(fitness: torch.Tensor, cands: torch.Tensor
                       ) -> torch.Tensor:
    """(n_picks,) winners: per row of ``cands`` (n_picks, k), the
    candidate with the highest fitness, the first one on a tie."""
    f = fitness[cands]
    k = cands.shape[1]
    pos = torch.arange(k, device=cands.device).expand_as(cands)
    first = torch.where(f == f.max(dim=1, keepdim=True).values, pos,
                        k).min(dim=1).values
    return cands.gather(1, first[:, None])[:, 0]


def single_point_crossover(mate: torch.Tensor, child: torch.Tensor,
                           pt: torch.Tensor) -> torch.Tensor:
    """Per row: concat(mate[:pt], child[pt:])."""
    cols = torch.arange(mate.shape[-1], device=mate.device)
    return torch.where(cols < pt[:, None], mate, child)


def mutate_gnn(genome: torch.Tensor, super_u: torch.Tensor,
               mut_u: torch.Tensor, noise: torch.Tensor, *, frac: float,
               std: float, super_prob: float = 0.05) -> torch.Tensor:
    """Per-gene Gaussian noise scaled by |g|+0.05 on a ``frac`` subset;
    whole-genome super-mutation (10x std) with prob ``super_prob``."""
    sd = torch.where(super_u < super_prob, std * 10.0, std)[:, None]
    mask = mut_u < frac
    return genome + (noise * sd * (genome.abs() + 0.05)) * mask


def mutate_boltz(flat: torch.Tensor, d: BoltzDraws, *, n_nodes: int,
                 frac: float) -> torch.Tensor:
    """Prior noise 0.3 and log_t noise 0.2, both on a ``3*frac`` subset;
    log_t clipped to [-3, 2]."""
    n_prior = bz.prior_size(n_nodes)
    prior, log_t = flat[:, :n_prior], flat[:, n_prior:]
    prior = prior + d.prior_noise * 0.3 * (d.prior_u < frac * 3)
    log_t = log_t + d.logt_noise * 0.2 * (d.logt_u < frac * 3)
    return torch.cat([prior, torch.clamp(log_t, -3.0, 2.0)], dim=1)


def evolve(gnn_pop: torch.Tensor, fit_g: torch.Tensor, bz_pop: torch.Tensor,
           fit_b: torch.Tensor, gnn_logits: torch.Tensor,
           draws: EvolveDraws, *, n_nodes: int, e_g: int, e_b: int,
           crossover_prob: float, mut_prob: float, mut_frac: float,
           mut_std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EA generation.  gnn_pop (n_g, V) flat GNN genomes; bz_pop
    (n_b, F) flat Boltzmann genomes; fit_* their fitness; gnn_logits
    (n_g, N, 2, 3) this generation's GNN posteriors (for cross-type
    seeding).  Returns the next (gnn_pop, bz_pop), elites first."""
    n_g, n_b = gnn_pop.shape[0], bz_pop.shape[0]
    new_g = gnn_pop
    order_g = torch.argsort(-fit_g, stable=True) if n_g else None
    if n_g:
        elites = gnn_pop[order_g[:e_g]]
        d = draws.g
        if n_g > e_g:
            parents = gnn_pop[tournament_indices(fit_g, d.cands)]
            crossed = single_point_crossover(elites[d.mate_idx], parents,
                                             d.cross_pt)
            children = torch.where((d.cross_u < crossover_prob)[:, None],
                                   crossed, parents)
            mutated = mutate_gnn(children, d.super_u, d.mut_u, d.mut_noise,
                                 frac=mut_frac, std=mut_std)
            children = torch.where((d.mut_gate_u < mut_prob)[:, None],
                                   mutated, children)
            new_g = torch.cat([elites, children])
        else:
            new_g = elites

    new_b = bz_pop
    if n_b:
        order_b = torch.argsort(-fit_b, stable=True)
        elites_b = bz_pop[order_b[:e_b]]
        d = draws.b
        if n_b > e_b:
            parents = bz_pop[tournament_indices(fit_b, d.cands)]
            children = parents
            if elite_pool_size(n_g, e_g, e_b):
                mi = d.mate_idx
                if n_g and e_g:
                    # a GNN elite as mate re-seeds the child from its
                    # posterior (Alg 2 lines 16-18)
                    elite_logits = gnn_logits[order_g[:e_g]]
                    seeded = bz.to_flat(*bz.seed_from_logits(
                        elite_logits[mi.clamp(0, e_g - 1)], d.seed_noise))
                    bz_mate = (elites_b[(mi - e_g).clamp(0, max(e_b - 1, 0))]
                               if e_b else parents)
                    crossed = torch.where(
                        (mi < e_g)[:, None], seeded,
                        single_point_crossover(bz_mate, parents, d.cross_pt))
                else:
                    crossed = single_point_crossover(elites_b[mi], parents,
                                                     d.cross_pt)
                children = torch.where((d.cross_u < crossover_prob)[:, None],
                                       crossed, parents)
            mutated = mutate_boltz(children, d, n_nodes=n_nodes,
                                   frac=mut_frac)
            children = torch.where((d.mut_gate_u < mut_prob)[:, None],
                                   mutated, children)
            new_b = torch.cat([elites_b, children])
        else:
            new_b = elites_b
    return new_g, new_b
