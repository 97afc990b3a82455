"""Built-in toy environments (gym-like API, no gym dependency).

The port's own copy of ray_tpu/rl/envs.py (numpy only, unchanged).

The suite's discrete tests define their own chain/grid envs inline; this
module hosts the CONTINUOUS-control one because several consumers (SAC,
its tests, examples) need the same dynamics.
"""

from __future__ import annotations

import numpy as np


class PendulumEnv:
    """Classic inverted-pendulum swing-up (the standard continuous
    benchmark: obs [cos th, sin th, thdot], torque in [-2, 2], reward
    -(th^2 + 0.1 thdot^2 + 0.001 u^2), 200-step episodes)."""

    obs_dim = 3
    action_dim = 1
    action_low = -2.0
    action_high = 2.0
    max_steps = 200

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.length = 1.0
        self._t = 0
        self.th = 0.0
        self.thdot = 0.0

    def reset(self):
        self.th = self.rng.uniform(-np.pi, np.pi)
        self.thdot = self.rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs()

    def _obs(self):
        return np.array(
            [np.cos(self.th), np.sin(self.th), self.thdot], np.float32
        )

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          self.action_low, self.action_high))
        th, thdot = self.th, self.thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (
            3 * self.g / (2 * self.length) * np.sin(th)
            + 3.0 / (self.m * self.length ** 2) * u
        ) * self.dt
        thdot = float(np.clip(thdot, -8.0, 8.0))
        th = th + thdot * self.dt
        self.th, self.thdot = th, thdot
        self._t += 1
        done = self._t >= self.max_steps
        # the only end is the TIME LIMIT: flag it so off-policy learners
        # bootstrap through it (gymnasium's terminated/truncated split)
        info = {"truncated": True} if done else {}
        return self._obs(), -cost, done, info
