"""EGRL (Algorithm 2) in PyTorch: the mixed EA population (GNN +
Boltzmann genomes) and the SAC learner sharing one replay buffer, with
PG->EA migration.

Counterpart of ``EGRL`` in ``src/repro/core/egrl.py``.  The population
is stored as stacked tensors on one device -- GNN genomes as one (n_g, V)
flat-parameter matrix, Boltzmann genomes as one (n_b, F) flat matrix --
and one generation is:

1. one population forward of the Graph U-Net (four batched ``gat_mp``
   launches, one per U-Net level),
2. Gumbel-max sampling of the GNN and Boltzmann mappings,
3. one simulator launch over those mappings (``evaluate_population``),
   and, outside "ea" mode, ``cfg.pg_rollouts`` rollouts of the SAC actor
   scored by a simulator launch of their own,
4. one EA step (``ea.evolve``), skipped when the population is empty
   ("pg" mode),
5. a host copy of (mappings, rewards, valid) into the replay buffer, in
   the order GNN, Boltzmann, PG, and for best-mapping tracking,
6. outside "ea" mode, one SAC gradient step per rollout
   (``SACLearner.update``), then in "egrl" mode the actor's weights
   replace the last GNN genome (the lowest-ranked child).

Modes: "egrl" (full), "ea" (ablate PG), "pg" (ablate EA) -- the paper's
agents.  The learner draws from a generator of its own, so the
population's draws, and so "ea" mode's trajectory, do not depend on it.

``ZooEGRL`` evolves one population against a zoo of workloads grouped
into size buckets (``graphs/bucketed.py``): per bucket one population
forward and one simulator launch for the population (one more for the
PG rollouts), fitness an aggregate ("mean" / "worst",
``REPRO_FITNESS_AGG``) of the per-graph rewards.  GNN genomes are the
same flat vectors as ``EGRL``'s; Boltzmann genomes span the
bucket-major padded node grid ``n_eff = sum_k G_k N_max_k``.  In
"egrl" mode ``ZooSAC`` trains from a per-graph ``ReplayBank``.  The
population code both classes share is ``_EvoPopulation``.
``evaluate_gnn_on`` / ``evaluate_gnn_zoo`` score a trained genome
zero-shot (Figure 5).

Several devices, one process (``pop_shards`` / ``REPRO_POP_SHARDS``,
``distributed.population``): the populations are split into row blocks,
one per shard device (``RowShards``), padded with throwaway rows where
a sub-population does not divide the shard count.  Each shard runs the
population forward (four ``gat_mp`` launches, per bucket in the zoo) and
one simulator launch over its GNN and Boltzmann rows on its own device,
against graph tensors staged there once; the EA step is
``ea.evolve_sharded``.  Every draw stays on the primary device at the
REAL counts and each shard receives copies of its rows' slices, so a
seeded run does not depend on the shard count; the learner, the replay
and the PG rollouts stay on the primary device, and the host copies
only real rows, in the order GNN, Boltzmann, PG.  ``ZooEGRL`` may
instead place its buckets on different devices (``dispatch`` /
``REPRO_BUCKET_DISPATCH``, ``distributed.dispatch``); it does so only
when the population is not sharded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import boltzmann as bz
from repro_torch.core import ea as ea_mod
from repro_torch.core import gnn
from repro_torch.core import params as P_
from repro_torch.core.replay import ReplayBank, ReplayBuffer
from repro_torch.core.sac import SACConfig, SACLearner, ZooSAC
from repro_torch.device import (DeviceLike, normalize_device, resolve_device,
                                same_type_devices)
from repro_torch.distributed.dispatch import BucketDispatcher
from repro_torch.distributed.population import (RowShards,
                                                resolve_pop_sharding)
from repro_torch.graphs.batch import GraphBatch
from repro_torch.graphs.bucketed import BucketedZoo, build_bucketed_zoo
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.memsim.batch import (aggregate_rewards,
                                      evaluate_population_bucketed)
from repro_torch.memsim.compiler import compiler_reference
from repro_torch.memsim.simulator import (SimGraph, build_sim_graph,
                                          evaluate_population)
from repro_torch.utils.envpolicy import env_policy


@dataclasses.dataclass
class EGRLConfig:
    pop_size: int = 20
    elites: int = 4
    boltzmann_frac: float = 0.2       # Table 2
    mut_prob: float = 0.9
    mut_frac: float = 0.1
    mut_std: float = 0.1
    crossover_prob: float = 0.7
    tournament_k: int = 3
    total_steps: int = 4000           # Table 2
    pg_rollouts: int = 1
    reward_scale: float = 5.0
    migrate_every: int = 1
    seed: int = 0
    sac: SACConfig = dataclasses.field(default_factory=SACConfig)


@dataclasses.dataclass
class GenerationDraws:
    """Every random number one generation uses: Gumbel noise for the
    GNN (n_g, N, 2, 3) and Boltzmann (n_b, N, 2, 3) samples, the EA
    step's draws and, outside "ea" mode, the PG rollouts' Gumbel noise
    (pg_rollouts, N, 2, 3) and the SAC action noise (one step per
    rollout, batch, N, 2, 3)."""
    gumbel_g: torch.Tensor
    gumbel_b: torch.Tensor
    evolve: ea_mod.EvolveDraws
    gumbel_pg: Optional[torch.Tensor] = None
    sac_noise: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ZooGenerationDraws:
    """Every random number one ``ZooEGRL`` generation uses: per bucket,
    Gumbel noise for the GNN samples (n_g, G_k, N_max_k, 2, 3); Gumbel
    noise for the Boltzmann samples over the bucket-major grid
    (n_b, n_eff, 2, 3); the EA step's draws (over n_eff nodes); outside
    "ea" mode, per bucket, the PG rollouts' Gumbel noise
    (pg_rollouts, G_k, N_max_k, 2, 3) and the SAC action noise (one step
    per rollout row, G_k, batch, N_max_k, 2, 3)."""
    gumbel_g: Tuple[torch.Tensor, ...]
    gumbel_b: torch.Tensor
    evolve: ea_mod.EvolveDraws
    gumbel_pg: Optional[Tuple[torch.Tensor, ...]] = None
    sac_noise: Optional[Tuple[torch.Tensor, ...]] = None


MODES = ("egrl", "ea", "pg")


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Extend a stacked (P, ...) tensor with zero rows up to ``rows``."""
    if x.shape[0] == rows:
        return x
    pad = torch.zeros((rows - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


class _EvoPopulation:
    """The population code ``EGRL`` and ``ZooEGRL`` share (JAX's
    ``_EvoPopulation``): the device and generator, the fixed population
    split and elite counts, the stacked genome init and its placement
    (one device, or row blocks over the pop shards), the EA step and the
    PG -> EA migration."""

    def _setup(self, cfg: EGRLConfig, mode: str, device: DeviceLike,
               generator: Optional[torch.Generator]):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose one of "
                             f"{', '.join(MODES)}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = mode
        self.gen = (generator if generator is not None else
                    torch.Generator(self.device).manual_seed(cfg.seed))
        if self.gen.device.type != self.device.type:
            raise ValueError(f"generator on {self.gen.device}, driver on "
                             f"{self.device}")

    def _split_population(self):
        """Fixed encoding slots (see core/ea.py): n_b Boltzmann + n_g GNN
        genomes whose counts never change; elites split proportionally
        (Python's round, as the JAX package)."""
        cfg = self.cfg
        if self.mode == "pg":
            self.n_g = self.n_b = 0
        else:
            self.n_b = max(1, int(round(cfg.pop_size * cfg.boltzmann_frac)))
            self.n_g = cfg.pop_size - self.n_b
        self.e_g = min(self.n_g, max(1, round(
            cfg.elites * self.n_g / max(cfg.pop_size, 1)))) if self.n_g else 0
        self.e_b = min(self.n_b, max(0, cfg.elites - self.e_g))

    def _init_populations(self, n_features: int, bz_nodes: int, pop_shards,
                          devices):
        """Stacked genomes from ``self.gen``: GNN (n_g, V) flat
        parameters, then Boltzmann (n_b, F) flats over ``bz_nodes`` node
        slots; then their placement: one tensor on the device, or, per
        the ``distributed.population`` policy over ``devices`` (default:
        every visible device of ``self.device``'s type), row blocks over the
        pop shards, padded with zero rows where a sub-population does
        not divide the shard count."""
        self.genome_size = P_.genome_size(P_.gnn_spec(n_features))
        gnn_pop = (torch.stack([P_.init_gnn(self.gen, n_features)
                                for _ in range(self.n_g)])
                   if self.n_g else
                   torch.zeros((0, self.genome_size), device=self.device))
        bz_pop = (torch.stack([bz.to_flat(*bz.init_boltzmann(
            self.gen, bz_nodes)) for _ in range(self.n_b)]) if self.n_b else
            torch.zeros((0, bz.flat_size(bz_nodes)), device=self.device))
        self.devices = same_type_devices(devices, self.device)
        self.pop_sharding = resolve_pop_sharding(
            self.n_g, self.n_b, pop_shards, devices=self.devices)
        self.n_g_pad, self.n_b_pad = self.pop_sharding.padded(self.n_g,
                                                              self.n_b)
        self.gnn_pop = self.pop_sharding.put(_pad_rows(gnn_pop, self.n_g_pad))
        self.bz_pop = self.pop_sharding.put(_pad_rows(bz_pop, self.n_b_pad))

    # --------------------------------------------------------- shards
    def _shards(self) -> List[Tuple[torch.Tensor, torch.Tensor,
                                    torch.device]]:
        """(GNN block, Boltzmann block, device) per pop shard; the whole
        populations on ``self.device`` when unsharded."""
        if not self.pop_sharding.active:
            return [(self.gnn_pop, self.bz_pop, self.device)]
        return list(zip(self.gnn_pop.parts, self.bz_pop.parts,
                        self.pop_sharding.devices))

    def _shard_rows(self, x: torch.Tensor, s: int, pop) -> torch.Tensor:
        """Shard ``s``'s rows of ``x`` (a draw over the REAL rows of the
        sub-population held by ``pop``), on its device; its padding rows
        draw zeros.  ``x`` itself when unsharded."""
        if not isinstance(pop, RowShards):
            return x
        lo, hi = pop.offsets[s], pop.offsets[s + 1]
        real = x[min(lo, x.shape[0]):min(hi, x.shape[0])]
        return _pad_rows(real, hi - lo).to(pop.parts[s].device)

    def _real_rows(self, per_shard: Sequence[torch.Tensor]) -> np.ndarray:
        """Host copy of the real rows of per-shard (GNN block rows +
        Boltzmann block rows, ...) tensors, GNN rows first."""
        arrs = [x.cpu().numpy() for x in per_shard]
        rg = [g.shape[0] for g, _, _ in self._shards()]
        g = np.concatenate([a[:r] for a, r in zip(arrs, rg)])[:self.n_g]
        b = np.concatenate([a[r:] for a, r in zip(arrs, rg)])[:self.n_b]
        return np.concatenate([g, b])

    def _row0(self) -> torch.Tensor:
        """GNN row 0 (the top elite after a generation), from shard 0."""
        pop = self.gnn_pop
        return (pop.block(0) if isinstance(pop, RowShards) else pop)[0]

    def _draw_evolve(self, n_nodes: int) -> ea_mod.EvolveDraws:
        return ea_mod.draw_evolve(
            self.gen, n_g=self.n_g, n_b=self.n_b, e_g=self.e_g, e_b=self.e_b,
            genome_size=self.genome_size, n_nodes=n_nodes,
            tournament_k=self.cfg.tournament_k)

    def _evolve(self, fitness: Sequence[torch.Tensor],
                logits_g: Sequence[torch.Tensor],
                draws: ea_mod.EvolveDraws, n_nodes: int):
        """One EA step on the population's fitness, per shard (GNN rows
        first) with the shard's GNN posteriors."""
        cfg = self.cfg
        kw = dict(n_nodes=n_nodes, e_g=self.e_g, e_b=self.e_b,
                  crossover_prob=cfg.crossover_prob, mut_prob=cfg.mut_prob,
                  mut_frac=cfg.mut_frac, mut_std=cfg.mut_std)
        if not self.pop_sharding.active:
            self.gnn_pop, self.bz_pop = ea_mod.evolve(
                self.gnn_pop, fitness[0][:self.n_g], self.bz_pop,
                fitness[0][self.n_g:], logits_g[0], draws, **kw)
            return
        rg = [g.shape[0] for g, _, _ in self._shards()]
        self.gnn_pop, self.bz_pop = ea_mod.evolve_sharded(
            self.pop_sharding, self.gnn_pop,
            RowShards([f[:r] for f, r in zip(fitness, rg)]), self.bz_pop,
            RowShards([f[r:] for f, r in zip(fitness, rg)]),
            RowShards(logits_g), draws, n_g=self.n_g, n_b=self.n_b, **kw)

    # ------------------------------------------------------- warm start
    def _to_device(self, x) -> torch.Tensor:
        """An f32 copy of ``x`` (numpy or CPU tensor) on the device."""
        return torch.tensor(np.array(x, np.float32), device=self.device)

    def _prior_logits(self, vec: torch.Tensor) -> torch.Tensor:
        """Posterior logits of the flat GNN params ``vec`` over this
        driver's Boltzmann node grid ((N, 2, 3) for ``EGRL``, the
        bucket-major (n_eff, 2, 3) grid for ``ZooEGRL``)."""
        raise NotImplementedError

    def prior_logits(self, vec) -> torch.Tensor:
        """The driver's Boltzmann-grid posterior logits for flat GNN
        params ``vec`` (numpy or CPU tensor): one population forward of one
        genome."""
        with torch.no_grad():
            return self._prior_logits(self._to_device(vec))

    def warm_start(self, vec, *, gnn_frac: float = 0.5,
                   noise_std: float = 0.05, t_init: float = 0.5,
                   logits=None, gnn_noise: Optional[torch.Tensor] = None,
                   bz_noise: Optional[torch.Tensor] = None):
        """Seed the population from a trained policy's flat GNN params
        (JAX's ``_EvoPopulation.warm_start``).  GNN row 0 becomes
        ``vec`` exactly, the next ``round(gnn_frac * n_g) - 1`` rows
        noisy copies ``vec + noise_std * gnn_noise``, the rest keep their
        init; every real Boltzmann genome is re-seeded from ``logits``
        (default: the prior's posterior, ``prior_logits(vec)``) by
        ``bz.seed_from_logits`` at temperature ``t_init``.

        The draws are explicit: ``gnn_noise`` (n_seed - 1, V) and
        ``bz_noise`` (n_b, grid, 2) standard normals, drawn from the
        generator ``self.gen`` in that order when not given.  A sharded
        population is written through its blocks; padding rows stay."""
        vec = self._to_device(vec)
        if self.n_g:
            n_seed = max(1, int(round(gnn_frac * self.n_g)))
            if gnn_noise is None:
                gnn_noise = torch.randn((n_seed - 1, vec.shape[0]),
                                        generator=self.gen,
                                        device=self.device)
            rows = torch.cat([vec[None], vec + noise_std * gnn_noise])
            if isinstance(self.gnn_pop, RowShards):
                self.gnn_pop.write(0, rows)
            else:
                self.gnn_pop = torch.cat([rows, self.gnn_pop[n_seed:]])
        if self.n_b:
            if logits is None:
                with torch.no_grad():
                    logits = self._prior_logits(vec)
            else:
                logits = self._to_device(logits)
            if bz_noise is None:
                bz_noise = torch.randn((self.n_b,) + logits.shape[:-1],
                                       generator=self.gen,
                                       device=self.device)
            rows = torch.stack([
                bz.to_flat(*bz.seed_from_logits(logits, noise, t_init))
                for noise in bz_noise])
            if isinstance(self.bz_pop, RowShards):
                self.bz_pop.write(0, rows)
            else:
                self.bz_pop = rows

    def _migrate(self):
        """In "egrl" mode the actor's weights replace the last real GNN
        genome, the lowest-ranked child (on the shard that owns it);
        when every GNN slot is an elite, elitism wins."""
        if self.mode == "egrl" and self.n_g > self.e_g:
            if isinstance(self.gnn_pop, RowShards):
                self.gnn_pop.write(self.n_g - 1, self.learner.actor[None])
            else:
                self.gnn_pop[self.n_g - 1] = self.learner.actor


class EGRL(_EvoPopulation):
    def __init__(self, graph: WorkloadGraph, cfg: EGRLConfig = EGRLConfig(),
                 mode: str = "egrl", device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 pop_shards=None, devices=None):
        """``pop_shards`` overrides ``REPRO_POP_SHARDS`` (an int, "auto"
        or "off"); ``devices`` lists the devices to shard over (default:
        every visible device of ``device``'s type; one may repeat)."""
        self._setup(cfg, mode, device, generator)
        self.g = graph
        self.feats = torch.as_tensor(graph.features(), device=self.device)
        self.adj = torch.as_tensor(graph.adjacency() > 0, device=self.device)
        self.sg = build_sim_graph(graph, self.device)
        _, self.ref_latency = compiler_reference(graph, self.device)

        self._split_population()
        self._init_populations(self.feats.shape[1], graph.n, pop_shards,
                               devices)
        # the graph's tensors, staged once on each shard's device
        self._staged = {}
        for _, _, dev in self._shards():
            self._graph_on(dev)
        self.learner = SACLearner(
            self.feats, self.adj, cfg.sac,
            torch.Generator(self.device).manual_seed(cfg.seed + 1))
        self.buffer = ReplayBuffer(graph.n, seed=cfg.seed)

        self.steps = 0
        self.best_reward = -np.inf
        self.best_mapping: Optional[np.ndarray] = None
        self.history: List[Dict] = []

    def _graph_on(self, dev) -> Tuple[torch.Tensor, torch.Tensor, SimGraph]:
        """(feats, mask, SimGraph) on ``dev``, copied there once."""
        key = normalize_device(dev)
        if key not in self._staged:
            self._staged[key] = (self.feats.to(key), self.adj.to(key),
                                 SimGraph(*(x.to(key) for x in self.sg)))
        return self._staged[key]

    # --------------------------------------------------------- generation
    def draw_generation(self) -> GenerationDraws:
        n = self.g.n
        d = GenerationDraws(
            gnn.gumbel((self.n_g, n, 2, 3), self.gen),
            gnn.gumbel((self.n_b, n, 2, 3), self.gen),
            self._draw_evolve(n))
        if self.mode != "ea":
            rollouts = self.cfg.pg_rollouts
            d.gumbel_pg = self.learner.draw_gumbel(rollouts)
            d.sac_noise = self.learner.draw_noise(
                self.n_g + self.n_b + rollouts)
        return d

    def generation(self, draws: Optional[GenerationDraws] = None) -> Dict:
        """One generation; ``draws`` (default: from the driver's
        generator) fixes every random number it uses."""
        with obs.profile_block(), obs.span("generation", driver="egrl",
                                           mode=self.mode):
            return self._generation(draws)

    def _generation(self, draws: Optional[GenerationDraws]) -> Dict:
        cfg = self.cfg
        d = self.draw_generation() if draws is None else draws
        n, n_pop = self.g.n, self.n_g + self.n_b
        shards = self._shards()
        logits_g, maps_g, maps_b, pop_maps, pop_res = [], [], [], [], []
        if n_pop:
            with obs.span("rollout.gnn", rows=self.n_g):
                for s, (g, _, dev) in enumerate(shards):
                    feats, adj, _ = self._graph_on(dev)
                    lg = (gnn.population_logits(g, feats, adj) if self.n_g
                          else torch.zeros((0, n, 2, 3), device=dev))
                    logits_g.append(lg)
                    maps_g.append(gnn.sample_actions(lg, self._shard_rows(
                        d.gumbel_g, s, self.gnn_pop)))
            with obs.span("rollout.boltzmann", rows=self.n_b):
                for s, (_, b, _) in enumerate(shards):
                    maps_b.append(bz.sample(bz.from_flat(b, n),
                                            self._shard_rows(d.gumbel_b, s,
                                                             self.bz_pop)))
        if self.mode != "ea":
            with obs.span("rollout.pg", rows=cfg.pg_rollouts):
                maps_pg = self.learner.explore_actions(
                    cfg.pg_rollouts, d.gumbel_pg).contiguous()
        with obs.span("evaluate", parts=len(shards) * (n_pop > 0)
                      + (self.mode != "ea")):
            # one simulator launch per shard over its GNN and Boltzmann
            # rows, on its device
            for mg, mb, (_, _, dev) in zip(maps_g, maps_b, shards):
                pop_maps.append(torch.cat([mg, mb]).contiguous())
                pop_res.append(evaluate_population(
                    self._graph_on(dev)[2], pop_maps[-1], self.ref_latency,
                    cfg.reward_scale))
            if self.mode != "ea":
                res_pg = evaluate_population(self.sg, maps_pg,
                                             self.ref_latency,
                                             cfg.reward_scale)
        if n_pop:
            self._evolve([r["reward"] for r in pop_res], logits_g, d.evolve,
                         n)

        # host copies of the real rows, once the generation's device
        # work is queued: GNN, Boltzmann, then PG
        parts = [(self._real_rows(pop_maps),
                  self._real_rows([r["reward"] for r in pop_res]),
                  self._real_rows([r["valid"] for r in pop_res]))] \
            if n_pop else []
        if self.mode != "ea":
            parts.append((maps_pg.cpu().numpy(),
                          res_pg["reward"].cpu().numpy(),
                          res_pg["valid"].cpu().numpy()))
        maps_np, rewards, valid = (np.concatenate(x) for x in zip(*parts))
        self.steps += len(maps_np)
        self.buffer.add_batch(maps_np, rewards)
        gen_best = int(np.argmax(rewards))
        if rewards[gen_best] > self.best_reward:
            self.best_reward = float(rewards[gen_best])
            self.best_mapping = maps_np[gen_best].copy()

        info = {}
        if self.mode != "ea":
            # one gradient step per rollout of this generation
            info = self.learner.update(self.buffer, len(maps_np),
                                       d.sac_noise)
            self._migrate()
        rec = {
            "steps": self.steps,
            "gen_best_reward": float(rewards.max()),
            "gen_mean_reward": float(rewards.mean()),
            "best_reward": self.best_reward,
            "best_speedup": self.best_reward / cfg.reward_scale
            if self.best_reward > 0 else 0.0,
            "valid_frac": float(valid.mean()),
            **info,
        }
        self.history.append(rec)
        return rec

    def train(self, total_steps: Optional[int] = None, log=None):
        total = total_steps or self.cfg.total_steps
        while self.steps < total:
            rec = self.generation()
            if log and len(self.history) % 10 == 1:
                log(f"[{self.mode}] steps {rec['steps']:5d} "
                    f"best speedup {rec['best_speedup']:.3f} "
                    f"valid {rec['valid_frac']:.2f}")
        return self.history

    # ----------------------------------------------------- deployment API
    def _prior_logits(self, vec: torch.Tensor) -> torch.Tensor:
        return gnn.population_logits(vec[None], self.feats, self.adj)[0]

    def best_policy_logits(self) -> torch.Tensor:
        """Logits of the top-ranked policy in the population: the best
        GNN, else the SAC actor, else (Boltzmann-only "ea" mode) the best
        Boltzmann prior."""
        if self.n_g:
            return gnn.population_logits(self._row0()[None].to(self.device),
                                         self.feats, self.adj)[0]
        if self.mode != "ea":
            return self.learner.policy_logits()
        bz0 = (self.bz_pop.block(0) if isinstance(self.bz_pop, RowShards)
               else self.bz_pop)[0].to(self.device)
        return bz.boltzmann_logits(bz.from_flat(bz0, self.g.n))

    def best_gnn_vec(self) -> np.ndarray:
        """Flat params of the best GNN (row 0 is the top elite after a
        generation; before any generation, an arbitrary init member), or
        the SAC actor's when the population holds no GNN genome."""
        if self.n_g:
            return self._row0().cpu().numpy()
        return self.learner.actor.cpu().numpy()


class ZooEGRL(_EvoPopulation):
    """Multi-workload EGRL: one population trained against a zoo of
    workloads, every generation scored with one simulator launch per
    size bucket (see the module docstring).  Steps count one per
    (genome, graph); the best reward and mapping are kept per graph."""

    def __init__(self, graphs: Sequence[WorkloadGraph],
                 cfg: EGRLConfig = EGRLConfig(), mode: str = "ea",
                 fitness_agg: Optional[str] = None,
                 zoo: Optional[BucketedZoo] = None, buckets=None,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 pop_shards=None, dispatch=None, devices=None):
        """``zoo`` reuses a prebuilt ``BucketedZoo`` (or a flat
        ``GraphBatch``, one bucket) on ``device``; ``buckets`` overrides
        ``REPRO_ZOO_BUCKETS`` ("auto" / "off" / K / "autotune");
        ``fitness_agg`` overrides ``REPRO_FITNESS_AGG`` ("mean" /
        "worst"); ``pop_shards`` overrides ``REPRO_POP_SHARDS`` and
        ``dispatch`` ``REPRO_BUCKET_DISPATCH`` ("auto" / "off" /
        "async"); ``devices`` lists the devices to spread over (default:
        every visible device of ``device``'s type; one may repeat)."""
        self._setup(cfg, mode, device, generator)
        self.agg = env_policy("REPRO_FITNESS_AGG", choices=("mean", "worst"),
                              default="mean", override=fitness_agg)
        if isinstance(zoo, GraphBatch):
            zoo = BucketedZoo.from_batch(zoo)
        self.zoo = (zoo if zoo is not None
                    else build_bucketed_zoo(graphs, buckets, self.device,
                                            devices))
        if self.zoo.device.type != self.device.type:
            raise ValueError(f"zoo on {self.zoo.device}, the search on "
                             f"{self.device}")
        self.n_graphs = self.zoo.n_graphs
        self.n_nodes = self.zoo.real_sizes()
        self.n_eff = self.zoo.n_eff
        self.masks = tuple(b.adj > 0 for b in self.zoo.buckets)
        self._offs = np.concatenate(
            [[0], np.cumsum([b.n_graphs * b.n_max
                             for b in self.zoo.buckets])])

        self._split_population()
        self._init_populations(self.zoo.n_features, self.n_eff, pop_shards,
                               devices)
        sharding = self.pop_sharding
        # wide layout (2-D ("pop", "model") mesh): the buckets whose
        # forward is within 2x of the costliest (G * N^2) split each pop
        # block's rows over its grid row; the others run on the block's
        # device
        if sharding.active and sharding.model_shards > 1:
            costs = [b.n_graphs * b.n_max ** 2 for b in self.zoo.buckets]
            self._wide_bucket = tuple(c * 2 >= max(costs) for c in costs)
        else:
            self._wide_bucket = (False,) * self.zoo.n_buckets
        # the zoo's tensors, staged once on each device the shards use
        self._staged = {}
        if sharding.active:
            for devs in sharding.wide_devices:
                for dev in devs:
                    self._zoo_on(dev)
        # bucket-parallel dispatch, only when the population is not
        # sharded (either/or, as in the JAX package)
        self.dispatch: Optional[BucketDispatcher] = None
        if not sharding.active:
            dsp = BucketDispatcher(self.zoo, policy=dispatch,
                                   devices=self.devices)
            self.dispatch = dsp if dsp.active else None
        if mode == "ea":
            self.learner, self.bank = None, None
        else:
            self.learner = ZooSAC(
                self.zoo, cfg.sac,
                torch.Generator(self.device).manual_seed(cfg.seed + 1))
            self.bank = ReplayBank(self.zoo.node_slots, seed=cfg.seed)

        self.steps = 0
        self.best_reward = np.full(self.n_graphs, -np.inf)
        self.best_mapping: List[Optional[np.ndarray]] = [None] * self.n_graphs
        self.best_fitness = -np.inf
        self.history: List[Dict] = []

    def _zoo_on(self, dev) -> Tuple[BucketedZoo, Tuple[torch.Tensor, ...]]:
        """(the zoo, its bucket masks) on ``dev``, copied there once."""
        key = normalize_device(dev)
        if key == normalize_device(self.zoo.device):
            return self.zoo, self.masks
        if key not in self._staged:
            z = self.zoo.to(key)
            self._staged[key] = (z, tuple(b.adj > 0 for b in z.buckets))
        return self._staged[key]

    def _split_grid(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(R, n_eff, ...) over the bucket-major grid -> per bucket
        (R, G_k, N_max_k, ...)."""
        return tuple(
            flat[:, self._offs[k]:self._offs[k + 1]].reshape(
                flat.shape[0], b.n_graphs, b.n_max, *flat.shape[2:])
            for k, b in enumerate(self.zoo.buckets))

    def population_logits(self, pop: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
        """(P, V) genomes -> per bucket (P, G_k, N_max_k, 2, 3), on
        ``pop``'s device."""
        z, masks = self._zoo_on(pop.device)
        return tuple(gnn.population_logits_zoo(pop, b.feats, mask,
                                               b.node_mask, b.n_nodes)
                     for b, mask in zip(z.buckets, masks))

    def _shard_logits(self, s: int, g: torch.Tensor, wide
                      ) -> Tuple[torch.Tensor, ...]:
        """Per bucket, the logits of shard ``s``'s GNN block ``g`` on its
        device; a wide bucket runs on the block's row split over the
        grid row (``wide[s]``) and gathers the pieces back."""
        if not any(self._wide_bucket):
            return self.population_logits(g)
        out = []
        for k, b in enumerate(self.zoo.buckets):
            pieces = wide[s].parts if self._wide_bucket[k] else (g,)
            lg = []
            for piece in pieces:
                z, masks = self._zoo_on(piece.device)
                bk = z.buckets[k]
                lg.append(gnn.population_logits_zoo(
                    piece, bk.feats, masks[k], bk.node_mask,
                    bk.n_nodes).to(g.device))
            out.append(torch.cat(lg) if len(lg) > 1 else lg[0])
        return tuple(out)

    # --------------------------------------------------------- generation
    def draw_generation(self) -> ZooGenerationDraws:
        d = ZooGenerationDraws(
            tuple(gnn.gumbel((self.n_g, b.n_graphs, b.n_max, 2, 3),
                             self.gen) for b in self.zoo.buckets),
            gnn.gumbel((self.n_b, self.n_eff, 2, 3), self.gen),
            self._draw_evolve(self.n_eff))
        if self.mode != "ea":
            rollouts = self.cfg.pg_rollouts
            d.gumbel_pg = self.learner.draw_gumbel(rollouts)
            d.sac_noise = self.learner.draw_noise(
                self.n_g + self.n_b + rollouts)
        return d

    def generation(self, draws: Optional[ZooGenerationDraws] = None) -> Dict:
        """One generation; ``draws`` (default: drawn from ``self.gen``)
        fixes every random number it uses."""
        with obs.profile_block(), obs.span("generation", driver="zoo",
                                           mode=self.mode):
            return self._generation(draws)

    def _generation(self, draws: Optional[ZooGenerationDraws]) -> Dict:
        cfg = self.cfg
        d = self.draw_generation() if draws is None else draws
        zoo, n_g, n_pop = self.zoo, self.n_g, self.n_g + self.n_b
        dsp = self.dispatch
        shards = self._shards()
        logits_g, maps_g, maps_b, pop_maps, pop_res = [], [], [], [], []
        if n_pop:
            with obs.span("rollout.gnn", rows=n_g, dispatch=dsp is not None):
                if n_g and dsp is not None:
                    # per-bucket forwards on their own devices; the
                    # logits come back to the primary device for the EA
                    # step's bucket-major grid
                    lg_dev = dsp.forward(self.gnn_pop)
                    maps_g.append(dsp.sample(d.gumbel_g, lg_dev))
                    logits_g.append(tuple(dsp.pull(lg_dev)))
                else:
                    wide = (self.pop_sharding.put_wide(self.gnn_pop)
                            if any(self._wide_bucket) else None)
                    for s, (g, _, dev) in enumerate(shards):
                        lg = (self._shard_logits(s, g, wide) if n_g else
                              tuple(torch.zeros((g.shape[0], b.n_graphs,
                                                 b.n_max, 2, 3), device=dev)
                                    for b in zoo.buckets))
                        logits_g.append(lg)
                        maps_g.append(tuple(
                            gnn.sample_actions(l, self._shard_rows(
                                gg, s, self.gnn_pop))
                            for l, gg in zip(lg, d.gumbel_g)))
            with obs.span("rollout.boltzmann", rows=self.n_b):
                for s, (_, b, _) in enumerate(shards):
                    maps_b.append(self._split_grid(bz.sample(
                        bz.from_flat(b, self.n_eff),
                        self._shard_rows(d.gumbel_b, s, self.bz_pop))))
        if self.mode != "ea":
            with obs.span("rollout.pg", rows=cfg.pg_rollouts):
                maps_pg = tuple(m.contiguous() for m in
                                self.learner.explore_actions(
                                    cfg.pg_rollouts, d.gumbel_pg))
        with obs.span("evaluate", parts=len(shards) * (n_pop > 0)
                      + (self.mode != "ea"), buckets=zoo.n_buckets,
                      dispatch=dsp is not None):
            # per shard, one simulator launch a bucket over its GNN and
            # Boltzmann rows, on its device (the bucket's, dispatched)
            for mg, mb, (_, _, dev) in zip(maps_g, maps_b, shards):
                maps = tuple(torch.cat([g, b.to(g.device)]).contiguous()
                             for g, b in zip(mg, mb))
                pop_maps.append(maps)
                pop_res.append(
                    dsp.evaluate(maps, cfg.reward_scale) if dsp is not None
                    else evaluate_population_bucketed(
                        self._zoo_on(dev)[0], maps, cfg.reward_scale))
            if self.mode != "ea":
                res_pg = (dsp.evaluate(maps_pg, cfg.reward_scale)
                          if dsp is not None else
                          evaluate_population_bucketed(zoo, maps_pg,
                                                       cfg.reward_scale))
        fit = [aggregate_rewards(r["reward"], self.agg) for r in pop_res]
        if n_pop:
            # Boltzmann seeding grid: bucket-major (rows, n_eff, 2, 3)
            grid = [torch.cat([l.reshape(l.shape[0], -1, 2, 3) if l.numel()
                               else l.new_zeros((l.shape[0],
                                                 l.shape[1] * l.shape[2],
                                                 2, 3)) for l in lg], dim=1)
                    for lg in logits_g]
            self._evolve(fit, grid, d.evolve, self.n_eff)

        # host copies of the real rows, once the generation's device
        # work is queued: GNN, Boltzmann, then PG
        parts = []                  # (rewards, fitness, valid, maps by bucket)
        if n_pop:
            parts.append((
                self._real_rows([r["reward"] for r in pop_res]),
                self._real_rows(fit),
                self._real_rows([r["valid"] for r in pop_res]),
                [self._real_rows([m[k] for m in pop_maps])
                 for k in range(zoo.n_buckets)]))
        if self.mode != "ea":
            parts.append((res_pg["reward"].cpu().numpy(),
                          aggregate_rewards(res_pg["reward"],
                                            self.agg).cpu().numpy(),
                          res_pg["valid"].cpu().numpy(),
                          [m.cpu().numpy() for m in maps_pg]))
        rewards, fitness, valid = (np.concatenate([p[i] for p in parts])
                                   for i in range(3))
        maps_np = [np.concatenate([p[3][k] for p in parts])
                   for k in range(zoo.n_buckets)]     # (R, G_k, N_max_k, 2)
        self.steps += rewards.size          # one per (genome, graph)
        acts_by_graph = [maps_np[zoo.graph_bucket[gi]][:, zoo.graph_slot[gi]]
                         for gi in range(self.n_graphs)]
        for gi in range(self.n_graphs):
            b = int(np.argmax(rewards[:, gi]))
            if rewards[b, gi] > self.best_reward[gi]:
                self.best_reward[gi] = float(rewards[b, gi])
                self.best_mapping[gi] = acts_by_graph[gi][
                    b, :self.n_nodes[gi]].copy()
        self.best_fitness = max(self.best_fitness, float(fitness.max()))

        info = {}
        if self.mode != "ea":
            for gi in range(self.n_graphs):
                self.bank.add_graph(gi, acts_by_graph[gi], rewards[:, gi])
            # one zoo-wide gradient step per rollout row
            info = self.learner.update(self.bank, len(rewards), d.sac_noise)
            self._migrate()
        rec = {
            "steps": self.steps,
            "gen_best_fitness": float(fitness.max()),
            "gen_mean_fitness": float(fitness.mean()),
            "best_fitness": self.best_fitness,
            "valid_frac": float(valid.mean()),
            "best_reward_per_graph": {
                name: float(self.best_reward[i])
                for i, name in enumerate(zoo.names)},
            **info,
        }
        self.history.append(rec)
        return rec

    def train(self, total_steps: Optional[int] = None, log=None):
        total = total_steps or self.cfg.total_steps
        while self.steps < total:
            rec = self.generation()
            if log and len(self.history) % 10 == 1:
                log(f"[zoo/{self.agg}] steps {rec['steps']:6d} "
                    f"best fitness {rec['best_fitness']:.3f} "
                    f"valid {rec['valid_frac']:.2f}")
        return self.history

    def _prior_logits(self, vec: torch.Tensor) -> torch.Tensor:
        # bucket-major (n_eff, 2, 3) grid, matching the bz genome layout
        return torch.cat([lg.reshape(1, -1, 2, 3) for lg in
                          self.population_logits(vec[None])], dim=1)[0]

    def best_gnn_vec(self) -> Optional[np.ndarray]:
        """Flat params of the best GNN after a generation (row 0), else
        the ZooSAC actor's ("pg" mode), else None."""
        if self.n_g:
            return self._row0().cpu().numpy()
        if self.learner is not None:
            return self.learner.actor.cpu().numpy()
        return None


def evaluate_gnn_on(graph: WorkloadGraph, vec, n_features: int = None,
                    samples: int = 8, seed: int = 0,
                    gumbel: Optional[torch.Tensor] = None,
                    device: DeviceLike = "cuda") -> float:
    """Zero-shot transfer (Figure 5): a trained GNN genome on another
    workload; the best speedup over ``samples`` Gumbel rollouts and the
    greedy one.  ``gumbel`` (samples, N, 2, 3) fixes the draws (default:
    a generator seeded ``seed``).  ``n_features`` is the JAX signature's;
    the genome's width fixes it."""
    dev = resolve_device(device)
    feats = torch.as_tensor(graph.features(), device=dev)
    mask = torch.as_tensor(graph.adjacency() > 0, device=dev)
    vec = torch.tensor(np.asarray(vec, np.float32), device=dev)
    if gumbel is None:
        gumbel = gnn.gumbel((samples, graph.n, 2, 3),
                            torch.Generator(dev).manual_seed(seed))
    with torch.no_grad():
        logits = gnn.gnn_forward(vec, feats, mask)
        acts = torch.cat([gnn.sample_actions(logits[None], gumbel),
                          gnn.greedy_actions(logits)[None]]).contiguous()
        sg = build_sim_graph(graph, dev)
        _, ref = compiler_reference(graph, dev)
        res = evaluate_population(sg, acts, ref)
    return float(res["speedup"].max())


def evaluate_gnn_zoo(graphs: Sequence[WorkloadGraph], vec,
                     samples: int = 8, seed: int = 0, batch=None,
                     gumbel: Optional[Sequence[torch.Tensor]] = None,
                     device: DeviceLike = "cuda") -> Dict[str, float]:
    """Zero-shot transfer (Figure 5) over a zoo, bucket by bucket: one
    masked forward and one simulator launch per bucket score ``samples``
    Gumbel rollouts and the greedy mapping on every graph.  Returns
    {graph name: best speedup} in zoo order.  ``batch`` reuses a
    ``BucketedZoo`` (or a flat ``GraphBatch``); ``gumbel`` fixes the
    draws, per bucket (samples, G_k, N_max_k, 2, 3) (default: a
    generator seeded ``seed``)."""
    if batch is None:
        zoo = build_bucketed_zoo(graphs, device=resolve_device(device))
    elif isinstance(batch, GraphBatch):
        zoo = BucketedZoo.from_batch(batch)
    else:
        zoo = batch
    dev = zoo.device
    vec = torch.tensor(np.asarray(vec, np.float32), device=dev)
    if gumbel is None:
        gen = torch.Generator(dev).manual_seed(seed)
        gumbel = [gnn.gumbel((samples, b.n_graphs, b.n_max, 2, 3), gen)
                  for b in zoo.buckets]
    with torch.no_grad():
        acts = tuple(
            torch.cat([gnn.sample_actions(lg[None], g),
                       gnn.greedy_actions(lg)[None]]).contiguous()
            for lg, g in zip(gnn.gnn_forward_bucketed(vec, zoo.buckets),
                             gumbel))
        res = evaluate_population_bucketed(zoo, acts)    # (S + 1, G)
    best = res["speedup"].amax(dim=0).cpu().numpy()
    return {name: float(best[i]) for i, name in enumerate(zoo.names)}
