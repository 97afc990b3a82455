"""Replay buffer (numpy ring) for off-policy algorithms.

Reference: rllib/utils/replay_buffers/replay_buffer.py — uniform-sample
ring buffer; host-side numpy (sampling feeds the learner's update, so the
buffer itself never needs to live on device).

The port's own copy of ray_tpu/rl/replay.py (numpy only, unchanged): the
same adds and seed give the same minibatches in both packages.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: int | None = None):
        """action_dim=None: discrete int actions (DQN); an int: float
        action VECTORS of that width (SAC-class continuous control)."""
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        if action_dim is None:
            self.actions = np.zeros(capacity, np.int32)
        else:
            self.actions = np.zeros((capacity, action_dim), np.float32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.bool_)
        self._idx = 0
        self._size = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, dones, next_obs):
        n = len(actions)
        for start in range(0, n, self.capacity):
            chunk = slice(start, min(start + self.capacity, n))
            m = chunk.stop - chunk.start
            pos = (self._idx + np.arange(m)) % self.capacity
            self.obs[pos] = obs[chunk]
            self.next_obs[pos] = next_obs[chunk]
            self.actions[pos] = actions[chunk]
            self.rewards[pos] = rewards[chunk]
            self.dones[pos] = dones[chunk]
            self._idx = int((self._idx + m) % self.capacity)
            self._size = int(min(self._size + m, self.capacity))

    def sample(self, batch_size: int) -> dict:
        idx = self._rng.randint(0, self._size, batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
            "next_obs": self.next_obs[idx],
        }
