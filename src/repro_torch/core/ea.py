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

Padded populations: when the stacked tensors carry extra rows so that a
population splits evenly over several devices
(``distributed.population``), ``n_g`` / ``n_b`` give the REAL counts.
The draws are sized by them, padding rows are never elites, parents or
mates (their fitness counts as ``-inf``), and each padding row receives
a throwaway copy of the last real row, as the JAX padded form does.

One block builder (``_evolve_rows``) writes the next rows [lo, hi) of
both sub-populations; ``evolve`` calls it once over every row, and
``evolve_sharded`` once per row block on several devices
(``RowShards``).  There the fitness vector (P floats) is gathered to
every shard, so the ranking, the elites, the tournament winners and the
mates are computed identically everywhere; each shard builds only the
rows it owns, fetching every parent, elite or mate row from the shard
that holds it (an ``index_select`` there, a copy here).  A shard's
transient stays O(rows owned x V); no shard holds a population-length
buffer.  It is only gathers, ``torch.where`` and the same elementwise
arithmetic on the same draws, so it equals ``evolve`` bit for bit for
any shard count.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.core import boltzmann as bz
from repro_torch.distributed.population import PopSharding, RowShards


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


# ------------------------------------------------------------ the step
def _real_fitness(fit, n_real: int, device: torch.device) -> torch.Tensor:
    """The real rows' (n_real,) fitness on ``device``, gathered from every
    block when ``fit`` is ``RowShards``: padding rows are never ranked, as
    if their fitness were -inf."""
    parts = fit.parts if isinstance(fit, RowShards) else (fit,)
    return torch.cat([p.to(device) for p in parts])[:n_real]


def _fetch(x, idx: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Rows ``idx`` (global row indices) of ``x`` on ``device``.  For a
    tensor, plain indexing; for ``RowShards``, every block index_selects
    the rows it holds on its own device, the copies come here and
    ``torch.where`` keeps each row from its owner.  Only copies, so the
    result is bitwise ``x.cat()[idx]``; the transient is len(idx) rows."""
    if not isinstance(x, RowShards):
        return x[idx.to(x.device)].to(device)
    out = None
    for part, lo in zip(x.parts, x.offsets):
        n = part.shape[0]
        if n == 0:
            continue
        li = idx.to(part.device) - lo
        rows = part.index_select(0, li.clamp(0, n - 1)).to(device)
        if out is None:
            out = rows
            continue
        own = ((li >= 0) & (li < n)).to(device)
        out = torch.where(own.view((-1,) + (1,) * (rows.dim() - 1)), rows,
                          out)
    return out


def _take(draws, c: List[int], device: torch.device):
    """The draws of children ``c`` (their leading index), on ``device``."""
    idx = torch.as_tensor(c, dtype=torch.long)
    out = {}
    for f in dataclasses.fields(draws):
        v = getattr(draws, f.name)
        out[f.name] = (None if v is None else
                       v.index_select(0, idx.to(v.device)).to(device))
    return type(draws)(**out)


def _owned(lo: int, hi: int, n_elite: int, n_child: int
           ) -> Tuple[List[int], List[int]]:
    """Of the slots [lo, hi): the elite slots (< n_elite) and, for the
    others, the child each builds (padding slots build the last child
    again; with no child at all, they are listed as elite slots
    n_elite - 1)."""
    slots = range(lo, hi)
    if not n_child:
        return [min(j, n_elite - 1) for j in slots], []
    return ([j for j in slots if j < n_elite],
            [min(j - n_elite, n_child - 1) for j in slots if j >= n_elite])


def _gnn_block(gnn_pop, fit_g: torch.Tensor, order_g, d, lo: int, hi: int,
               device, *, n_g: int, e_g: int, crossover_prob: float,
               mut_prob: float, mut_frac: float, mut_std: float
               ) -> torch.Tensor:
    """The next GNN rows [lo, hi) on ``device``."""
    elite_slots, cs = _owned(lo, hi, e_g, n_g - e_g)
    rows = []
    if elite_slots:
        rows.append(_fetch(gnn_pop, order_g[elite_slots], device))
    if cs:
        d = _take(d, cs, device)
        parents = _fetch(gnn_pop, tournament_indices(fit_g, d.cands), device)
        mates = _fetch(gnn_pop, order_g[d.mate_idx], device)
        crossed = single_point_crossover(mates, parents, d.cross_pt)
        children = torch.where((d.cross_u < crossover_prob)[:, None],
                               crossed, parents)
        mutated = mutate_gnn(children, d.super_u, d.mut_u, d.mut_noise,
                             frac=mut_frac, std=mut_std)
        rows.append(torch.where((d.mut_gate_u < mut_prob)[:, None], mutated,
                                children))
    return torch.cat(rows) if len(rows) > 1 else rows[0]


def _bz_block(bz_pop, fit_b: torch.Tensor, order_b, gnn_logits, order_g, d,
              lo: int, hi: int, device, *, n_g: int, n_b: int, e_g: int,
              e_b: int, n_nodes: int, crossover_prob: float, mut_prob: float,
              mut_frac: float) -> torch.Tensor:
    """The next Boltzmann rows [lo, hi) on ``device``."""
    elite_slots, cs = _owned(lo, hi, e_b, n_b - e_b)
    rows = []
    if elite_slots:
        rows.append(_fetch(bz_pop, order_b[elite_slots], device))
    if cs:
        d = _take(d, cs, device)
        parents = _fetch(bz_pop, tournament_indices(fit_b, d.cands), device)
        children = parents
        if elite_pool_size(n_g, e_g, e_b):
            mi = d.mate_idx
            if n_g and e_g:
                # a GNN elite as mate re-seeds the child from its
                # posterior (Alg 2 lines 16-18)
                elite_logits = _fetch(gnn_logits,
                                      order_g[mi.clamp(0, e_g - 1)], device)
                seeded = bz.to_flat(*bz.seed_from_logits(elite_logits,
                                                         d.seed_noise))
                bz_mate = (_fetch(bz_pop, order_b[(mi - e_g).clamp(
                    0, max(e_b - 1, 0))], device) if e_b else parents)
                crossed = torch.where(
                    (mi < e_g)[:, None], seeded,
                    single_point_crossover(bz_mate, parents, d.cross_pt))
            else:
                crossed = single_point_crossover(
                    _fetch(bz_pop, order_b[mi], device), parents, d.cross_pt)
            children = torch.where((d.cross_u < crossover_prob)[:, None],
                                   crossed, parents)
        mutated = mutate_boltz(children, d, n_nodes=n_nodes, frac=mut_frac)
        rows.append(torch.where((d.mut_gate_u < mut_prob)[:, None], mutated,
                                children))
    return torch.cat(rows) if len(rows) > 1 else rows[0]


def _evolve_rows(gnn_pop, fit_g, bz_pop, fit_b, gnn_logits,
                 draws: EvolveDraws, g_rows: Tuple[int, int],
                 b_rows: Tuple[int, int], device: torch.device, *, n_g: int,
                 n_b: int, n_nodes: int, e_g: int, e_b: int,
                 crossover_prob: float, mut_prob: float, mut_frac: float,
                 mut_std: float
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The next GNN rows ``g_rows`` = [lo, hi) and Boltzmann rows
    ``b_rows`` on ``device``, from whole populations given as tensors or
    ``RowShards``; None where the range or the sub-population is empty
    (those rows stay as they are)."""
    kw = dict(crossover_prob=crossover_prob, mut_prob=mut_prob,
              mut_frac=mut_frac)
    new_g = new_b = order_g = None
    if n_g:
        fg = _real_fitness(fit_g, n_g, device)
        order_g = torch.argsort(-fg, stable=True)
        if g_rows[0] < g_rows[1]:
            new_g = _gnn_block(gnn_pop, fg, order_g, draws.g, *g_rows, device,
                               n_g=n_g, e_g=e_g, mut_std=mut_std, **kw)
    if n_b and b_rows[0] < b_rows[1]:
        fb = _real_fitness(fit_b, n_b, device)
        new_b = _bz_block(bz_pop, fb, torch.argsort(-fb, stable=True),
                          gnn_logits, order_g, draws.b, *b_rows, device,
                          n_g=n_g, n_b=n_b, e_g=e_g, e_b=e_b,
                          n_nodes=n_nodes, **kw)
    return new_g, new_b


def evolve(gnn_pop: torch.Tensor, fit_g: torch.Tensor, bz_pop: torch.Tensor,
           fit_b: torch.Tensor, gnn_logits: torch.Tensor,
           draws: EvolveDraws, *, n_nodes: int, e_g: int, e_b: int,
           crossover_prob: float, mut_prob: float, mut_frac: float,
           mut_std: float, n_g: Optional[int] = None,
           n_b: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EA generation.  gnn_pop (n_g, V) flat GNN genomes; bz_pop
    (n_b, F) flat Boltzmann genomes; fit_* their fitness; gnn_logits
    (n_g, N, 2, 3) this generation's GNN posteriors (for cross-type
    seeding).  ``n_g`` / ``n_b`` give the REAL sub-population sizes when
    the tensors carry padding rows (default: every row is real); the
    draws are sized by them and the padding rows' fitness is never read.
    Returns the next (gnn_pop, bz_pop), elites first, at the input row
    counts: padding rows hold throwaway copies of the last real row."""
    rows_g, rows_b = gnn_pop.shape[0], bz_pop.shape[0]
    new_g, new_b = _evolve_rows(
        gnn_pop, fit_g, bz_pop, fit_b, gnn_logits, draws, (0, rows_g),
        (0, rows_b), gnn_pop.device, n_g=rows_g if n_g is None else n_g,
        n_b=rows_b if n_b is None else n_b, n_nodes=n_nodes, e_g=e_g,
        e_b=e_b, crossover_prob=crossover_prob, mut_prob=mut_prob,
        mut_frac=mut_frac, mut_std=mut_std)
    return (gnn_pop if new_g is None else new_g,
            bz_pop if new_b is None else new_b)


def evolve_sharded(sharding: PopSharding, gnn_pop, fit_g, bz_pop, fit_b,
                   gnn_logits, draws: EvolveDraws, *, n_nodes: int, e_g: int,
                   e_b: int, crossover_prob: float, mut_prob: float,
                   mut_frac: float, mut_std: float, n_g: Optional[int] = None,
                   n_b: Optional[int] = None
                   ) -> Tuple[RowShards, RowShards]:
    """``evolve`` with the population split into row blocks over the pop
    shards of ``sharding``.  The populations and ``gnn_logits`` are
    ``RowShards`` (a tensor is split by ``sharding.put``); ``fit_g`` /
    ``fit_b`` are ``RowShards`` or tensors (padding rows' values are never
    read).  Both row counts must divide the shard count (pad with
    ``distributed.population``); ``n_g`` / ``n_b`` give the REAL counts,
    which size ``draws``.  Each shard builds its own block of rows with
    the code ``evolve`` runs, so it equals ``evolve`` on the padded
    tensors bit for bit, and on real rows the unpadded single-device
    step, for any shard count."""
    if not sharding.active:
        raise ValueError("evolve_sharded needs an active PopSharding; use "
                         "evolve on a single device")
    n_g_pad, n_b_pad = gnn_pop.shape[0], bz_pop.shape[0]
    S = sharding.n_shards
    if (n_g_pad % S) or (n_b_pad % S):
        raise ValueError(
            f"population rows (n_g={n_g_pad}, n_b={n_b_pad}) not divisible "
            f"by the {S} pop shards; pad the populations "
            f"(distributed.population does this) or disable sharding "
            f"(REPRO_POP_SHARDS=1)")
    gnn_pop, bz_pop = sharding.put(gnn_pop), sharding.put(bz_pop)
    n_g = n_g_pad if n_g is None else n_g
    n_b = n_b_pad if n_b is None else n_b
    if n_g and n_b and e_g:
        gnn_logits = sharding.put(gnn_logits)
    kw = dict(n_g=n_g, n_b=n_b, n_nodes=n_nodes, e_g=e_g, e_b=e_b,
              crossover_prob=crossover_prob, mut_prob=mut_prob,
              mut_frac=mut_frac, mut_std=mut_std)
    new_g, new_b = [], []
    for s, dev in enumerate(sharding.devices):
        g, b = _evolve_rows(
            gnn_pop, fit_g, bz_pop, fit_b, gnn_logits, draws,
            (gnn_pop.offsets[s], gnn_pop.offsets[s + 1]),
            (bz_pop.offsets[s], bz_pop.offsets[s + 1]), dev, **kw)
        new_g.append(gnn_pop.parts[s] if g is None else g)
        new_b.append(bz_pop.parts[s] if b is None else b)
    return RowShards(new_g), RowShards(new_b)
