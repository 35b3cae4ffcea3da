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
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.batch import GraphBatch
from repro_torch.graphs.bucketed import BucketedZoo, build_bucketed_zoo
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.memsim.batch import (aggregate_rewards,
                                      evaluate_population_bucketed)
from repro_torch.memsim.compiler import compiler_reference
from repro_torch.memsim.simulator import build_sim_graph, evaluate_population
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


class _EvoPopulation:
    """The population code ``EGRL`` and ``ZooEGRL`` share (JAX's
    ``_EvoPopulation``): the device and generator, the fixed population
    split and elite counts, the stacked genome init, the EA step and the
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

    def _init_populations(self, n_features: int, bz_nodes: int):
        """Stacked genomes from ``self.gen``: GNN (n_g, V) flat
        parameters, then Boltzmann (n_b, F) flats over ``bz_nodes`` node
        slots."""
        self.genome_size = P_.genome_size(P_.gnn_spec(n_features))
        self.gnn_pop = (torch.stack([P_.init_gnn(self.gen, n_features)
                                     for _ in range(self.n_g)])
                        if self.n_g else
                        torch.zeros((0, self.genome_size), device=self.device))
        self.bz_pop = (torch.stack([bz.to_flat(*bz.init_boltzmann(
            self.gen, bz_nodes)) for _ in range(self.n_b)]) if self.n_b else
            torch.zeros((0, bz.flat_size(bz_nodes)), device=self.device))

    def _draw_evolve(self, n_nodes: int) -> ea_mod.EvolveDraws:
        return ea_mod.draw_evolve(
            self.gen, n_g=self.n_g, n_b=self.n_b, e_g=self.e_g, e_b=self.e_b,
            genome_size=self.genome_size, n_nodes=n_nodes,
            tournament_k=self.cfg.tournament_k)

    def _evolve(self, fitness: torch.Tensor, logits_g: torch.Tensor,
                draws: ea_mod.EvolveDraws, n_nodes: int):
        """One EA step on the population's fitness (GNN rows first)."""
        cfg = self.cfg
        self.gnn_pop, self.bz_pop = ea_mod.evolve(
            self.gnn_pop, fitness[:self.n_g], self.bz_pop,
            fitness[self.n_g:], logits_g, draws, n_nodes=n_nodes,
            e_g=self.e_g, e_b=self.e_b, crossover_prob=cfg.crossover_prob,
            mut_prob=cfg.mut_prob, mut_frac=cfg.mut_frac,
            mut_std=cfg.mut_std)

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
        init; every Boltzmann genome is re-seeded from ``logits``
        (default: the prior's posterior, ``prior_logits(vec)``) by
        ``bz.seed_from_logits`` at temperature ``t_init``.

        The draws are explicit: ``gnn_noise`` (n_seed - 1, V) and
        ``bz_noise`` (n_b, grid, 2) standard normals, drawn from the
        driver's generator in that order when not given."""
        vec = self._to_device(vec)
        if self.n_g:
            n_seed = max(1, int(round(gnn_frac * self.n_g)))
            if gnn_noise is None:
                gnn_noise = torch.randn((n_seed - 1, vec.shape[0]),
                                        generator=self.gen,
                                        device=self.device)
            rows = torch.cat([vec[None], vec + noise_std * gnn_noise])
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
            self.bz_pop = torch.stack([
                bz.to_flat(*bz.seed_from_logits(logits, noise, t_init))
                for noise in bz_noise])

    def _migrate(self):
        """In "egrl" mode the actor's weights replace the last GNN genome,
        the lowest-ranked child; when every GNN slot is an elite, elitism
        wins."""
        if self.mode == "egrl" and self.n_g > self.e_g:
            self.gnn_pop[self.n_g - 1] = self.learner.actor


class EGRL(_EvoPopulation):
    def __init__(self, graph: WorkloadGraph, cfg: EGRLConfig = EGRLConfig(),
                 mode: str = "egrl", device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        self._setup(cfg, mode, device, generator)
        self.g = graph
        self.feats = torch.as_tensor(graph.features(), device=self.device)
        self.adj = torch.as_tensor(graph.adjacency() > 0, device=self.device)
        self.sg = build_sim_graph(graph, self.device)
        _, self.ref_latency = compiler_reference(graph, self.device)

        self._split_population()
        self._init_populations(self.feats.shape[1], graph.n)
        self.learner = SACLearner(
            self.feats, self.adj, cfg.sac,
            torch.Generator(self.device).manual_seed(cfg.seed + 1))
        self.buffer = ReplayBuffer(graph.n, seed=cfg.seed)

        self.steps = 0
        self.best_reward = -np.inf
        self.best_mapping: Optional[np.ndarray] = None
        self.history: List[Dict] = []

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
        parts = []                       # (mappings, simulator result)
        logits_g = (gnn.population_logits(self.gnn_pop, self.feats, self.adj)
                    if self.n_g else
                    torch.zeros((0, n, 2, 3), device=self.device))
        if n_pop:
            maps_g = gnn.sample_actions(logits_g, d.gumbel_g)
            maps_b = bz.sample(bz.from_flat(self.bz_pop, n), d.gumbel_b)
            maps = torch.cat([maps_g, maps_b]).contiguous()
            parts.append((maps, evaluate_population(
                self.sg, maps, self.ref_latency, cfg.reward_scale)))
        if self.mode != "ea":
            maps = self.learner.explore_actions(cfg.pg_rollouts,
                                                d.gumbel_pg).contiguous()
            parts.append((maps, evaluate_population(
                self.sg, maps, self.ref_latency, cfg.reward_scale)))
        if n_pop:
            self._evolve(parts[0][1]["reward"], logits_g, d.evolve, n)

        # host copies, once the generation's device work is queued
        rewards = torch.cat([r["reward"] for _, r in parts]).cpu().numpy()
        maps_np = torch.cat([m for m, _ in parts]).cpu().numpy()
        valid = torch.cat([r["valid"] for _, r in parts]).cpu().numpy()
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
            return gnn.population_logits(self.gnn_pop[:1], self.feats,
                                         self.adj)[0]
        if self.mode != "ea":
            return self.learner.policy_logits()
        return bz.boltzmann_logits(bz.from_flat(self.bz_pop[0], self.g.n))

    def best_gnn_vec(self) -> np.ndarray:
        """Flat params of the best GNN (row 0 is the top elite after a
        generation; before any generation, an arbitrary init member), or
        the SAC actor's when the population holds no GNN genome."""
        if self.n_g:
            return self.gnn_pop[0].cpu().numpy()
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
                 generator: Optional[torch.Generator] = None):
        """``zoo`` reuses a prebuilt ``BucketedZoo`` (or a flat
        ``GraphBatch``, one bucket) on ``device``; ``buckets`` overrides
        ``REPRO_ZOO_BUCKETS`` ("auto" / "off" / K); ``fitness_agg``
        overrides ``REPRO_FITNESS_AGG`` ("mean" / "worst")."""
        self._setup(cfg, mode, device, generator)
        self.agg = env_policy("REPRO_FITNESS_AGG", choices=("mean", "worst"),
                              default="mean", override=fitness_agg)
        if isinstance(zoo, GraphBatch):
            zoo = BucketedZoo.from_batch(zoo)
        self.zoo = (zoo if zoo is not None
                    else build_bucketed_zoo(graphs, buckets, self.device))
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
        self._init_populations(self.zoo.n_features, self.n_eff)
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

    def _split_grid(self, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(R, n_eff, ...) over the bucket-major grid -> per bucket
        (R, G_k, N_max_k, ...)."""
        return tuple(
            flat[:, self._offs[k]:self._offs[k + 1]].reshape(
                flat.shape[0], b.n_graphs, b.n_max, *flat.shape[2:])
            for k, b in enumerate(self.zoo.buckets))

    def population_logits(self, pop: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
        """(P, V) genomes -> per bucket (P, G_k, N_max_k, 2, 3)."""
        return tuple(gnn.population_logits_zoo(pop, b.feats, mask,
                                               b.node_mask, b.n_nodes)
                     for b, mask in zip(self.zoo.buckets, self.masks))

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
        parts = []                # (per-bucket mappings, simulator result)
        logits_g = (self.population_logits(self.gnn_pop) if n_g else
                    tuple(torch.zeros((0, b.n_graphs, b.n_max, 2, 3),
                                      device=self.device)
                          for b in zoo.buckets))
        if n_pop:
            maps_b = self._split_grid(bz.sample(
                bz.from_flat(self.bz_pop, self.n_eff), d.gumbel_b))
            maps = tuple(torch.cat([gnn.sample_actions(lg, gg), mb])
                         .contiguous()
                         for lg, gg, mb in zip(logits_g, d.gumbel_g, maps_b))
            parts.append((maps, evaluate_population_bucketed(
                zoo, maps, cfg.reward_scale)))
        if self.mode != "ea":
            maps = tuple(m.contiguous() for m in self.learner.explore_actions(
                cfg.pg_rollouts, d.gumbel_pg))
            parts.append((maps, evaluate_population_bucketed(
                zoo, maps, cfg.reward_scale)))
        fit = [aggregate_rewards(r["reward"], self.agg) for _, r in parts]
        if n_pop:
            # Boltzmann seeding grid: bucket-major (n_g, n_eff, 2, 3)
            grid = torch.cat([lg.reshape(n_g, -1, 2, 3) for lg in logits_g],
                             dim=1)
            self._evolve(fit[0], grid, d.evolve, self.n_eff)

        # host copies, once the generation's device work is queued
        rewards = torch.cat([r["reward"] for _, r in parts]).cpu().numpy()
        fitness = torch.cat(fit).cpu().numpy()
        valid = torch.cat([r["valid"] for _, r in parts]).cpu().numpy()
        maps_np = [torch.cat([m[k] for m, _ in parts]).cpu().numpy()
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
            return self.gnn_pop[0].cpu().numpy()
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
