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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import boltzmann as bz
from repro_torch.core import ea as ea_mod
from repro_torch.core import gnn
from repro_torch.core import params as P_
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.sac import SACConfig, SACLearner
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import WorkloadGraph
from repro_torch.memsim.compiler import compiler_reference
from repro_torch.memsim.simulator import build_sim_graph, evaluate_population


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


MODES = ("egrl", "ea", "pg")


class EGRL:
    def __init__(self, graph: WorkloadGraph, cfg: EGRLConfig = EGRLConfig(),
                 mode: str = "egrl", device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose one of "
                             f"{', '.join(MODES)}")
        self.device = resolve_device(device)
        self.g = graph
        self.cfg = cfg
        self.mode = mode
        self.gen = (generator if generator is not None else
                    torch.Generator(self.device).manual_seed(cfg.seed))
        if self.gen.device.type != self.device.type:
            raise ValueError(f"generator on {self.gen.device}, driver on "
                             f"{self.device}")

        self.feats = torch.as_tensor(graph.features(), device=self.device)
        self.adj = torch.as_tensor(graph.adjacency() > 0, device=self.device)
        self.sg = build_sim_graph(graph, self.device)
        _, self.ref_latency = compiler_reference(graph, self.device)

        self._split_population()
        n_feat = self.feats.shape[1]
        self.genome_size = P_.genome_size(P_.gnn_spec(n_feat))
        self.gnn_pop = (torch.stack([P_.init_gnn(self.gen, n_feat)
                                     for _ in range(self.n_g)])
                        if self.n_g else
                        torch.zeros((0, self.genome_size), device=self.device))
        self.bz_pop = (torch.stack([bz.to_flat(*bz.init_boltzmann(
            self.gen, graph.n)) for _ in range(self.n_b)]) if self.n_b else
            torch.zeros((0, bz.flat_size(graph.n)), device=self.device))
        self.learner = SACLearner(
            self.feats, self.adj, cfg.sac,
            torch.Generator(self.device).manual_seed(cfg.seed + 1))
        self.buffer = ReplayBuffer(graph.n, seed=cfg.seed)

        self.steps = 0
        self.best_reward = -np.inf
        self.best_mapping: Optional[np.ndarray] = None
        self.history: List[Dict] = []

    def _split_population(self):
        """Fixed encoding slots (see core/ea.py): n_b Boltzmann + n_g GNN
        genomes whose counts never change; elites split proportionally
        (Python's round, as the JAX driver)."""
        cfg = self.cfg
        if self.mode == "pg":
            self.n_g = self.n_b = 0
        else:
            self.n_b = max(1, int(round(cfg.pop_size * cfg.boltzmann_frac)))
            self.n_g = cfg.pop_size - self.n_b
        self.e_g = min(self.n_g, max(1, round(
            cfg.elites * self.n_g / max(cfg.pop_size, 1)))) if self.n_g else 0
        self.e_b = min(self.n_b, max(0, cfg.elites - self.e_g))

    # --------------------------------------------------------- generation
    def draw_generation(self) -> GenerationDraws:
        n = self.g.n
        d = GenerationDraws(
            gnn.gumbel((self.n_g, n, 2, 3), self.gen),
            gnn.gumbel((self.n_b, n, 2, 3), self.gen),
            ea_mod.draw_evolve(
                self.gen, n_g=self.n_g, n_b=self.n_b, e_g=self.e_g,
                e_b=self.e_b, genome_size=self.genome_size, n_nodes=n,
                tournament_k=self.cfg.tournament_k))
        if self.mode != "ea":
            rollouts = self.cfg.pg_rollouts
            d.gumbel_pg = self.learner.draw_gumbel(rollouts)
            d.sac_noise = self.learner.draw_noise(
                self.n_g + self.n_b + rollouts)
        return d

    def generation(self, draws: Optional[GenerationDraws] = None) -> Dict:
        """One generation; ``draws`` (default: from the driver's
        generator) fixes every random number it uses."""
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
            reward = parts[0][1]["reward"]
            self.gnn_pop, self.bz_pop = ea_mod.evolve(
                self.gnn_pop, reward[:self.n_g], self.bz_pop,
                reward[self.n_g:], logits_g, d.evolve, n_nodes=n,
                e_g=self.e_g, e_b=self.e_b,
                crossover_prob=cfg.crossover_prob, mut_prob=cfg.mut_prob,
                mut_frac=cfg.mut_frac, mut_std=cfg.mut_std)

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
            # migration into the last GNN slot, the lowest-ranked child;
            # when every GNN slot is an elite, elitism wins
            if self.mode == "egrl" and self.n_g > self.e_g:
                self.gnn_pop[self.n_g - 1] = self.learner.actor
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
