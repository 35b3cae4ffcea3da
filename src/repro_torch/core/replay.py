"""Shared replay buffer (Appendix C): every rollout from every member of
the mixed population lands here; the SAC learner samples from it. The
state (workload graph) is constant within a task, so entries store only
(action, reward).

A copy of ``ReplayBuffer`` and ``ReplayBank`` in
``src/repro/core/replay.py``: numpy with ``np.random.default_rng(seed)``,
so the same seed and inserts sample the same indices as the JAX
package's buffers.

``ReplayBank`` is the multi-workload form: one ``ReplayBuffer`` per zoo
index, storing that graph's rollout rows at its bucket's padded width
``node_slots[i]``; a ``ZooEGRL`` generation inserts per graph
(``add_graph``) and the ``ZooSAC`` update samples per bucket
(``sample_bucket``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class ReplayBuffer:
    def __init__(self, n_nodes: int, capacity: int = 100_000, seed: int = 0):
        self.actions = np.zeros((capacity, n_nodes, 2), np.int8)
        self.rewards = np.zeros((capacity,), np.float32)
        self.capacity = capacity
        self.size = 0
        self.ptr = 0
        self.rng = np.random.default_rng(seed)

    def add(self, actions, reward):
        self.actions[self.ptr] = np.asarray(actions, np.int8)
        self.rewards[self.ptr] = float(reward)
        self.ptr = (self.ptr + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def add_batch(self, actions, rewards):
        """Vectorized ring-buffer insert of a whole generation."""
        actions = np.asarray(actions, np.int8)
        rewards = np.asarray(rewards, np.float32)
        n = len(actions)
        if n >= self.capacity:
            actions, rewards = actions[-self.capacity:], rewards[-self.capacity:]
            n = self.capacity
        idx = (self.ptr + np.arange(n)) % self.capacity
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.ptr = int((self.ptr + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch: int):
        idx = self.rng.integers(0, self.size, size=batch)
        return (self.actions[idx].astype(np.int32), self.rewards[idx])

    def __len__(self):
        return self.size


class ReplayBank:
    """Per-zoo-index replay for the workload zoo (see module docstring).

    ``node_slots[i]`` is the padded action-row width of zoo graph i
    (its bucket's N_max_k); buffers store exactly what the bucketed
    rollouts produce, so sampling needs no re-padding.  Buffer i is
    seeded ``seed + i`` — an index stream keyed by ZOO position, stable
    under any bucketing policy — and a one-graph bank reproduces a
    ``ReplayBuffer(seed=seed)`` sample stream exactly (the ZooSAC G=1
    parity contract).
    """

    def __init__(self, node_slots: Sequence[int], capacity: int = 100_000,
                 seed: int = 0):
        self.node_slots = tuple(int(n) for n in node_slots)
        self.buffers = [ReplayBuffer(n, capacity, seed + i)
                        for i, n in enumerate(self.node_slots)]

    def add_graph(self, i: int, actions, rewards):
        """One zoo graph's generation rows: actions (P, node_slots[i],
        2), rewards (P,) into buffer i."""
        self.buffers[i].add_batch(actions, rewards)

    def add_batch(self, actions, rewards):
        """Uniform-width insert: actions (P, G, N_max, 2), rewards
        (P, G) — row p of graph g lands in buffer g.  Only valid when
        every graph shares one padded width (single-bucket zoos)."""
        actions = np.asarray(actions)
        rewards = np.asarray(rewards)
        for i, buf in enumerate(self.buffers):
            buf.add_batch(actions[:, i], rewards[:, i])

    def sample_bucket(self, indices: Sequence[int], batch: int, steps: int):
        """(steps, len(indices), batch, N_k, 2) int32 actions +
        (steps, len(indices), batch) float32 rewards for one bucket's
        zoo indices (all sharing one padded width).  Each buffer's draw
        stream is its own seeded rng, so the per-buffer sequence is
        independent of bucket iteration order — sampling per bucket
        draws exactly what a flat per-zoo sweep would."""
        widths = {self.node_slots[i] for i in indices}
        assert len(widths) == 1, f"mixed widths in one bucket: {widths}"
        acts = np.empty((steps, len(indices), batch, widths.pop(), 2),
                        np.int32)
        rews = np.empty((steps, len(indices), batch), np.float32)
        for u in range(steps):
            for j, i in enumerate(indices):
                acts[u, j], rews[u, j] = self.buffers[i].sample(batch)
        return acts, rews

    def sample_stack(self, batch: int, steps: int):
        """Uniform-width form of ``sample_bucket`` over the whole zoo:
        (steps, G, batch, N_max, 2) + (steps, G, batch).  Per (step,
        graph) the draw order matches the single-buffer
        ``[buf.sample(batch) for _ in range(steps)]`` sequence."""
        return self.sample_bucket(range(len(self.buffers)), batch, steps)

    def __len__(self):
        """Transitions available in EVERY graph's buffer (they fill in
        lockstep under ZooEGRL, so this is just buffer 0's size
        — min() keeps it honest for hand-filled banks)."""
        return min((len(b) for b in self.buffers), default=0)
