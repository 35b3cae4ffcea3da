"""Shared replay buffer (Appendix C): every rollout from every member of
the mixed population lands here; the SAC learner samples from it. The
state (workload graph) is constant within a task, so entries store only
(action, reward).

A copy of ``ReplayBuffer`` in ``src/repro/core/replay.py``: numpy with
``np.random.default_rng(seed)``, so the same seed and inserts sample the
same indices as the JAX package's buffer.
"""
from __future__ import annotations

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
