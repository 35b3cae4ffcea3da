"""SAC policy-gradient learner for the multi-discrete placement action
(Appendix D), in PyTorch.

Counterpart of ``SACLearner`` and ``ZooSAC`` in ``src/repro/core/sac.py``:

- discrete entropy computed exactly and averaged over nodes;
- double-Q critic evaluated on NOISY one-hot behavioural actions
  (clipped Gaussian);
- actor trained through the critic with the softmax probabilities as a
  differentiable soft action;
- single-step episodes, so the Bellman target is the scaled reward and
  no target networks exist.

Actor and critic are flat parameter vectors (``core/params.py``, JAX
leaf order), and Adam is hand-rolled on them in the JAX float order, so
a state moves between the packages unchanged (``convert.py``).  The
batch of B actions is a batch axis: each critic GAT level is ONE
``gat_mp`` call at batch B over the shared graph mask.  Both losses
differentiate through ``gat_mp``'s ``autograd.Function``, whose
backward on CUDA tensors is the kernel ``csrc/gat_mp_bwd.cu``.

``ZooSAC`` is the multi-workload member of ``ZooEGRL``: actor and
critic run over a size-bucketed zoo, each bucket at its own padded
width, one ``gat_mp`` call per level and bucket (the critic's batch is
G_k graphs x B transitions, each graph's mask shared by its B
transitions).  Its losses are the per-graph ``SACLearner`` losses,
concatenated bucket-major and averaged, so a one-graph zoo reduces to
``SACLearner``.

The JAX package runs a generation's gradient steps as one jitted
``lax.scan``; here they are a Python loop.  Every random draw (rollout
Gumbel noise, action noise) comes from the learner's ``torch.Generator``
or is passed in by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import gnn
from repro_torch.core import params as P_
from repro_torch.core.replay import ReplayBank, ReplayBuffer
from repro_torch.graphs.batch import GraphBatch
from repro_torch.graphs.bucketed import BucketedZoo


@dataclasses.dataclass
class SACConfig:
    lr_actor: float = 1e-3
    lr_critic: float = 1e-3
    alpha: float = 0.05
    batch: int = 24
    action_noise: float = 0.2
    noise_clip: float = 0.5


def critic_forward(critic: torch.Tensor, feats: torch.Tensor,
                   mask: torch.Tensor, act_onehot: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double-Q critic over one graph with every node real (the
    all-ones-mask case of the JAX ``critic_forward_masked``).

    critic (Vc,) flat; feats (N, F); mask (N, N) bool; act_onehot
    (B, N, 2, 3) noisy or soft one-hots -> (q1 (B,), q2 (B,))."""
    p = P_.unflatten(critic[None], P_.critic_spec(feats.shape[1]))
    B, N = act_onehot.shape[:2]
    x = torch.cat([feats.expand(B, *feats.shape),
                   act_onehot.reshape(B, N, P_.N_SUB * P_.N_TIER)], -1)
    h = torch.tanh(torch.matmul(x, p["inp"][0]))                  # (B, N, D)
    h = gnn._gat(p, 0, h, mask[None])
    h = gnn._gat(p, 1, h, mask[None])
    g = h.sum(dim=1) / N                                          # (B, D)
    q = [torch.matmul(F.elu(torch.matmul(g, p[f"h{k}"][0]) + p[f"b{k}"][0]),
                      p[f"q{k}"][0])[:, 0] for k in (1, 2)]
    return q[0], q[1]


def critic_forward_masked(critic: torch.Tensor, feats: torch.Tensor,
                          mask: torch.Tensor, node_mask: torch.Tensor,
                          act_onehot: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double-Q critic over G padded graphs, T actions each: critic (Vc,)
    flat; feats (G, N_max, F); mask (G, N_max, N_max) bool (padded rows
    self-loop only); node_mask (G, N_max) f32; act_onehot
    (G, T, N_max, 2, 3) -> (q1 (G, T), q2 (G, T)).

    Padded rows are zeroed at the input and after each GAT level, and
    the global pool divides by the real node count, so padding content
    cannot reach the Q values.  The batch is graph-major (b = g T + t)
    and each GAT level is one ``gat_mp`` call with graph g's mask shared
    by its T actions.  With no padding and G = 1 this is
    ``critic_forward``."""
    p = P_.unflatten(critic[None], P_.critic_spec(feats.shape[-1]))
    G, T, N = act_onehot.shape[:3]
    live = node_mask.to(feats.dtype)[:, None, :].expand(G, T, N)
    live = live.reshape(G * T, N, 1)
    x = torch.cat([feats[:, None].expand(G, T, *feats.shape[1:]),
                   act_onehot.reshape(G, T, N, P_.N_SUB * P_.N_TIER)], -1)
    x = x.view(G * T, N, -1) * live
    h = torch.tanh(torch.matmul(x, p["inp"][0])) * live         # (B, N, D)
    h = gnn._gat(p, 0, h, mask, rep=T) * live
    h = gnn._gat(p, 1, h, mask, rep=T) * live
    g = h.sum(dim=1) / torch.clamp(live.sum(dim=1), min=1.0)      # (B, D)
    q = [torch.matmul(F.elu(torch.matmul(g, p[f"h{k}"][0]) + p[f"b{k}"][0]),
                      p[f"q{k}"][0])[:, 0].view(G, T) for k in (1, 2)]
    return q[0], q[1]


def adam_init(params: torch.Tensor) -> Dict:
    return {"m": torch.zeros_like(params), "v": torch.zeros_like(params),
            "t": 0}


def adam_step(lr: float, params: torch.Tensor, grads: torch.Tensor,
              state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One Adam step on a flat parameter vector, in the float order of
    the JAX ``_adam_step`` (elementwise per leaf, so one flat vector is
    exact): bias corrections ``1 - b ** t`` in float32, then
    ``p - lr * (m / c1) / (sqrt(v / c2) + eps)``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = state["t"] + 1
    m = b1 * state["m"] + (1 - b1) * grads
    v = b2 * state["v"] + (1 - b2) * grads * grads
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    new = params - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
    return new, {"m": m, "v": v, "t": t}


class _Learner:
    """What both learners share: the eager gradient-step loop, and the
    state of actor, critic and both Adam optimisers."""

    def _gradient_steps(self, steps: int, onehots, rewards
                        ) -> Dict[str, float]:
        """``steps`` steps; ``onehots(u)`` / ``rewards(u)`` are step u's
        critic inputs.  Each step: one critic Adam step on the noisy
        one-hot behavioural actions, then one actor Adam step through the
        updated critic.  Returns the last step's losses."""
        cfg = self.cfg
        for u in range(steps):
            critic = self.critic.detach().requires_grad_()
            closs = self.critic_loss(critic, onehots(u), rewards(u))
            (cg,) = torch.autograd.grad(closs, critic)
            self.critic, self.opt_c = adam_step(cfg.lr_critic, self.critic,
                                                cg, self.opt_c)
            actor = self.actor.detach().requires_grad_()
            aloss, ent = self.actor_loss(actor, self.critic)
            (ag,) = torch.autograd.grad(aloss, actor)
            self.actor, self.opt_a = adam_step(cfg.lr_actor, self.actor, ag,
                                               self.opt_a)
        return {"critic_loss": float(closs.detach()),
                "actor_loss": float(aloss.detach()),
                "entropy": float(ent.detach())}

    # ------------------------------------------------------------ state
    def state(self) -> Dict:
        """Actor, critic and both Adam states (``convert.sac_state_*``)."""
        return {"actor": self.actor, "critic": self.critic,
                "opt_a": dict(self.opt_a), "opt_c": dict(self.opt_c)}

    def load_state(self, state: Dict) -> None:
        dev = self.actor.device

        def put(x):
            return x.to(device=dev, dtype=torch.float32).clone()

        self.actor, self.critic = put(state["actor"]), put(state["critic"])
        for k in ("opt_a", "opt_c"):
            setattr(self, k, {"m": put(state[k]["m"]),
                              "v": put(state[k]["v"]),
                              "t": int(state[k]["t"])})


class SACLearner(_Learner):
    def __init__(self, feats: torch.Tensor, adj: torch.Tensor,
                 cfg: SACConfig = SACConfig(),
                 generator: Optional[torch.Generator] = None):
        """feats (N, F) and adj (N, N) (bool mask, or the row-normalised
        float adjacency) on the learner's device; ``generator`` (on the
        same device) makes the init and every later draw."""
        self.cfg = cfg
        self.feats = feats
        self.mask = adj if adj.dtype == torch.bool else adj > 0
        self.gen = (generator if generator is not None
                    else torch.Generator(feats.device).manual_seed(0))
        self.actor = P_.init_gnn(self.gen, feats.shape[1])
        self.critic = P_.init_critic(self.gen, feats.shape[1])
        self.opt_a = adam_init(self.actor)
        self.opt_c = adam_init(self.critic)

    # ------------------------------------------------------------ losses
    def critic_loss(self, critic: torch.Tensor, acts_oh: torch.Tensor,
                    rewards: torch.Tensor) -> torch.Tensor:
        """acts_oh (B, N, 2, 3), rewards (B,) -> mean double-Q error."""
        q1, q2 = critic_forward(critic, self.feats, self.mask, acts_oh)
        return torch.mean((q1 - rewards) ** 2 + (q2 - rewards) ** 2)

    def actor_loss(self, actor: torch.Tensor, critic: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-(min(q1, q2) + alpha * entropy) of the actor's soft action;
        returns (loss, entropy)."""
        logits = gnn.gnn_forward(actor, self.feats, self.mask)
        probs = torch.softmax(logits, dim=-1)
        q1, q2 = critic_forward(critic, self.feats, self.mask, probs[None])
        ent = gnn.entropy(logits)
        return -(torch.minimum(q1, q2)[0] + self.cfg.alpha * ent), ent

    # ------------------------------------------------------------- draws
    def draw_gumbel(self, n: int) -> torch.Tensor:
        """Gumbel noise for ``n`` rollouts, (n, N, 2, 3)."""
        return gnn.gumbel((n, self.feats.shape[0], P_.N_SUB, P_.N_TIER),
                          self.gen)

    def draw_noise(self, steps: int) -> torch.Tensor:
        """Clipped Gaussian action noise for ``steps`` gradient steps,
        (steps, batch, N, 2, 3)."""
        cfg = self.cfg
        shape = (steps, cfg.batch, self.feats.shape[0], P_.N_SUB, P_.N_TIER)
        noise = torch.randn(shape, generator=self.gen, device=self.gen.device)
        return torch.clamp(cfg.action_noise * noise, -cfg.noise_clip,
                           cfg.noise_clip)

    # ----------------------------------------------------------- policy
    def policy_logits(self, params: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        with torch.no_grad():
            return gnn.gnn_forward(self.actor if params is None else params,
                                   self.feats, self.mask)

    def explore_actions(self, n: int,
                        gumbel: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """(n, N, 2) int32 rollout actions from one actor forward: the
        Gumbel-max sample of each row of ``gumbel`` (default: drawn)."""
        g = self.draw_gumbel(n) if gumbel is None else gumbel
        return gnn.sample_actions(self.policy_logits()[None], g)

    # ----------------------------------------------------------- update
    def update(self, buffer: ReplayBuffer, steps: int,
               noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """``steps`` gradient steps, each on a fresh replay batch: one
        critic Adam step on the noisy one-hot behavioural actions, then
        one actor Adam step through the updated critic.  ``noise``
        (steps, batch, N, 2, 3) fixes the action noise (default: drawn).
        Returns the last step's losses, or {} while the buffer holds
        fewer than one batch."""
        cfg = self.cfg
        if len(buffer) < cfg.batch or steps <= 0:
            return {}
        dev = self.actor.device
        pairs = [buffer.sample(cfg.batch) for _ in range(steps)]
        acts = torch.as_tensor(np.stack([p[0] for p in pairs]), device=dev)
        rews = torch.as_tensor(np.stack([p[1] for p in pairs]), device=dev)
        noise = self.draw_noise(steps) if noise is None else noise
        return self._gradient_steps(
            steps,
            lambda u: F.one_hot(acts[u].long(), P_.N_TIER).float() + noise[u],
            lambda u: rews[u])


class ZooSAC(_Learner):
    """Multi-workload SAC learner over a size-bucketed zoo, the PG member
    of ``ZooEGRL``.  The actor is the masked zoo forward
    (``gnn.gnn_forward_zoo``) once per bucket; the double-Q critic is
    ``critic_forward_masked`` per bucket at its padded width.  Each
    gradient step trains on one (G_k, B) replay batch per bucket, B
    transitions from every workload's buffer of a ``ReplayBank``."""

    def __init__(self, zoo, cfg: SACConfig = SACConfig(),
                 generator: Optional[torch.Generator] = None):
        """``zoo`` a ``BucketedZoo`` (or a flat ``GraphBatch``, one
        bucket) on the learner's device; ``generator`` (on the same
        device) makes the init and every later draw."""
        if isinstance(zoo, GraphBatch):
            zoo = BucketedZoo.from_batch(zoo)
        self.cfg = cfg
        self.zoo = zoo
        self.gen = (generator if generator is not None
                    else torch.Generator(zoo.device).manual_seed(0))
        self.actor = P_.init_gnn(self.gen, zoo.n_features)
        self.critic = P_.init_critic(self.gen, zoo.n_features)
        self.opt_a = adam_init(self.actor)
        self.opt_c = adam_init(self.critic)
        self.masks = tuple(b.adj > 0 for b in zoo.buckets)
        # zoo indices per bucket, slot order (for the replay sampler)
        self._bucket_ids = tuple(
            tuple(i for i in range(zoo.n_graphs) if zoo.graph_bucket[i] == k)
            for k in range(zoo.n_buckets))

    # ------------------------------------------------------------ losses
    def critic_loss(self, critic: torch.Tensor, acts_oh, rewards
                    ) -> torch.Tensor:
        """acts_oh: per bucket (G_k, B, N_max_k, 2, 3); rewards: per
        bucket (G_k, B) -> the mean over graphs of each graph's mean
        double-Q error (concatenated bucket-major)."""
        losses = []
        for b, mask, oh, r in zip(self.zoo.buckets, self.masks, acts_oh,
                                  rewards):
            q1, q2 = critic_forward_masked(critic, b.feats, mask,
                                           b.node_mask, oh)
            losses.append(torch.mean((q1 - r) ** 2 + (q2 - r) ** 2, dim=1))
        return torch.mean(torch.cat(losses))

    def actor_loss(self, actor: torch.Tensor, critic: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-(mean over graphs of min(q1, q2) + alpha * mean entropy) of
        the actor's soft action; returns (loss, entropy)."""
        qs, ents = [], []
        for b, mask in zip(self.zoo.buckets, self.masks):
            logits = gnn.gnn_forward_zoo(actor, b.feats, mask, b.node_mask,
                                         b.n_nodes)
            probs = torch.softmax(logits, dim=-1)
            q1, q2 = critic_forward_masked(critic, b.feats, mask,
                                           b.node_mask, probs[:, None])
            qs.append(torch.minimum(q1, q2)[:, 0])
            ents.append(gnn.entropy_masked(logits, b.node_mask))
        ent = torch.mean(torch.cat(ents))
        return -(torch.mean(torch.cat(qs)) + self.cfg.alpha * ent), ent

    # ------------------------------------------------------------- draws
    def draw_gumbel(self, n: int) -> Tuple[torch.Tensor, ...]:
        """Gumbel noise for ``n`` rollouts, per bucket
        (n, G_k, N_max_k, 2, 3)."""
        return tuple(gnn.gumbel((n, b.n_graphs, b.n_max, P_.N_SUB,
                                 P_.N_TIER), self.gen)
                     for b in self.zoo.buckets)

    def draw_noise(self, steps: int) -> Tuple[torch.Tensor, ...]:
        """Clipped Gaussian action noise for ``steps`` gradient steps,
        per bucket (steps, G_k, batch, N_max_k, 2, 3)."""
        cfg = self.cfg
        out = []
        for b in self.zoo.buckets:
            shape = (steps, b.n_graphs, cfg.batch, b.n_max, P_.N_SUB,
                     P_.N_TIER)
            noise = torch.randn(shape, generator=self.gen,
                                device=self.gen.device)
            out.append(torch.clamp(cfg.action_noise * noise,
                                   -cfg.noise_clip, cfg.noise_clip))
        return tuple(out)

    # ----------------------------------------------------------- policy
    def policy_logits(self, params: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
        """Per bucket (G_k, N_max_k, 2, 3) logits, padded rows 0."""
        vec = self.actor if params is None else params
        with torch.no_grad():
            return tuple(gnn.gnn_forward_zoo(vec, b.feats, mask, b.node_mask,
                                             b.n_nodes)
                         for b, mask in zip(self.zoo.buckets, self.masks))

    def explore_actions(self, n: int, gumbel=None
                        ) -> Tuple[torch.Tensor, ...]:
        """Per bucket (n, G_k, N_max_k, 2) int32 rollout actions from one
        actor forward per bucket: the Gumbel-max sample of each row of
        ``gumbel`` (per bucket; default: drawn).  Padded rows sample
        throwaway actions, inert downstream."""
        g = self.draw_gumbel(n) if gumbel is None else gumbel
        return tuple(gnn.sample_actions(lg[None], gk)
                     for lg, gk in zip(self.policy_logits(), g))

    # ----------------------------------------------------------- update
    def update(self, bank: ReplayBank, steps: int,
               noise=None) -> Dict[str, float]:
        """``steps`` zoo-wide gradient steps, each on a fresh per-bucket
        (G_k, batch) replay batch from the bank; ``noise`` (per bucket
        (steps, G_k, batch, N_max_k, 2, 3)) fixes the action noise
        (default: drawn).  Returns the last step's losses, or {} while a
        buffer holds fewer than one batch."""
        cfg = self.cfg
        if len(bank) < cfg.batch or steps <= 0:
            return {}
        dev = self.actor.device
        acts, rews = [], []
        for ids in self._bucket_ids:
            a, r = bank.sample_bucket(ids, cfg.batch, steps)
            acts.append(torch.as_tensor(a, device=dev))
            rews.append(torch.as_tensor(r, device=dev))
        noise = self.draw_noise(steps) if noise is None else noise
        return self._gradient_steps(
            steps,
            lambda u: tuple(F.one_hot(a[u].long(), P_.N_TIER).float() + n[u]
                            for a, n in zip(acts, noise)),
            lambda u: tuple(r[u] for r in rews))
