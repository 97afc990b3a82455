"""Vectorized environment sampling, in PyTorch.

Mirrors ray_tpu/rl/vector_env.py (reference rllib/env/vector_env.py +
evaluation/env_runner_v2.py:199): one runner steps N env copies in
lockstep and runs ONE batched policy forward per step ([N, obs]) instead
of N scalar forwards. A plain class spawned through the algorithm's
runtime, on the ``device`` it passes (``"cpu"``, as JAX pins its runners
there: env_runner.py's docstring says why).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env_runner import EpisodeReturns, softmax_sample


class VectorEnvRunner:
    """N env copies, batched policy forward, contiguous [T, N] batches."""

    def __init__(self, env_creator, obs_dim: int, n_actions: int,
                 num_envs: int = 4, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.envs = [env_creator() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.rng = np.random.RandomState(seed)
        self._obs = np.stack(
            [np.asarray(e.reset(), np.float32) for e in self.envs])
        self._returns = EpisodeReturns(num_envs)
        self.params = None

    def set_weights(self, params):
        self.params = models.as_tensors(params, self.device)
        return True

    @torch.no_grad()
    def _fwd(self, obs: np.ndarray):
        logits, values = models.forward(
            self.params, torch.from_numpy(obs).to(self.device))
        return logits.cpu().numpy(), values.cpu().numpy()

    def sample(self, n_steps: int) -> dict:
        """n_steps lockstep steps -> [T, N] arrays (time-major per env
        trajectories, so V-trace can run over them)."""
        N = self.num_envs
        obs_l, act_l, logp_l, val_l, rew_l, done_l = ([] for _ in range(6))
        for _ in range(n_steps):
            logits, values = self._fwd(self._obs)
            actions, logp = softmax_sample(self.rng, logits)

            obs_l.append(self._obs.copy())
            act_l.append(actions)
            logp_l.append(logp)
            val_l.append(np.asarray(values, np.float32))

            rewards = np.zeros(N, np.float32)
            dones = np.zeros(N, bool)
            for i, env in enumerate(self.envs):
                o, r, d, _ = env.step(int(actions[i]))
                rewards[i] = r
                dones[i] = d
                self._returns.step(i, float(r), bool(d))
                if d:
                    o = env.reset()
                self._obs[i] = np.asarray(o, np.float32)
            rew_l.append(rewards)
            done_l.append(dones)

        _, last_values = self._fwd(self._obs)
        ep_mean = self._returns.mean()
        return {
            "obs": np.stack(obs_l),  # [T, N, obs]
            "actions": np.stack(act_l).astype(np.int32),  # [T, N]
            "logp": np.stack(logp_l),  # [T, N]
            "values": np.stack(val_l),  # [T, N]
            "rewards": np.stack(rew_l),  # [T, N]
            "dones": np.stack(done_l),  # [T, N]
            "last_values": np.asarray(last_values, np.float32),  # [N]
            "episode_return_mean": ep_mean,
        }
