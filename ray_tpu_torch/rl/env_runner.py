"""EnvRunner: the environment-sampling member, in PyTorch.

Mirrors ray_tpu/rl/env_runner.py (reference rllib/evaluation/
rollout_worker.py:166 + sampler.py): a member holding an env and the
current policy weights; ``sample()`` runs the env loop and returns a
batch dict. Env API is gym-like: reset() -> obs, step(a) -> (obs,
reward, done, info). JAX makes it a ray_tpu actor; here it is a plain
class that an algorithm spawns through its runtime (``serve.runtime``:
in-process by default).

Placement: the JAX runner pins itself to the CPU
(``jax.config.update("jax_platforms", "cpu")``, ray_tpu/rl/env_runner.py:22,
and vector_env.py:25): its forward is one observation (or one row per
env) through a 64-wide MLP, so it is host-bound and a device would add
a round trip a step. The port keeps that placement as the ``device``
the algorithms pass, ``RUNNER_DEVICE``; the learner runs on its own
device.
Sampling is numpy ``RandomState`` over the policy's float64 softmax, as
in JAX, so from the same weights and seed the port's runners sample
the same actions.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import connectors as _conn
from ray_tpu_torch.rl import models

# where the algorithms place their runners (the docstring says why)
RUNNER_DEVICE = "cpu"


class EnvRunner:
    def __init__(self, env_creator, obs_dim: int, n_actions: int,
                 seed: int = 0, connectors=None, device=None):
        self.device = resolve_device(device)
        self.env = env_creator()
        self.rng = np.random.RandomState(seed)
        # env_to_module connector pipeline (a factory or a
        # connectors.pack_factory blob); obs_dim refers to the
        # POST-connector width (e.g. FrameStack(k) multiplies it by k)
        self.obs_pipe = _conn.pipeline_from_blob(connectors)
        self._obs = self.obs_pipe(np.asarray(self.env.reset(), np.float32))
        self.params = None

    def set_weights(self, params):
        self.params = models.as_tensors(params, self.device)
        return True

    @torch.no_grad()
    def _fwd(self, obs: np.ndarray):
        logits, value = models.forward(
            self.params, torch.from_numpy(obs).to(self.device))
        return logits.cpu().numpy(), value.cpu().numpy()

    def sample(self, n_steps: int) -> dict:
        """Collect n_steps transitions with the current policy."""
        obs_l, act_l, rew_l, done_l, logp_l, val_l = [], [], [], [], [], []
        obs = self._obs
        for _ in range(n_steps):
            logits, value = self._fwd(obs[None])
            a, lp = softmax_sample(self.rng, logits[0])
            nxt, r, done, _ = self.env.step(a)
            obs_l.append(obs)
            act_l.append(a)
            rew_l.append(float(r))
            done_l.append(bool(done))
            logp_l.append(lp)
            val_l.append(float(value[0]))
            if done:
                self.obs_pipe.reset()
                obs = self.obs_pipe(
                    np.asarray(self.env.reset(), np.float32))
            else:
                obs = self.obs_pipe(np.asarray(nxt, np.float32))
        # bootstrap value of the final obs for GAE
        _, last_v = self._fwd(obs[None])
        self._obs = obs
        return {
            "obs": np.stack(obs_l).astype(np.float32),
            "actions": np.asarray(act_l, np.int32),
            "rewards": np.asarray(rew_l, np.float32),
            "dones": np.asarray(done_l, np.bool_),
            "logp": np.asarray(logp_l, np.float32),
            "values": np.asarray(val_l, np.float32),
            "last_value": float(last_v[0]),
            "episode_return_mean": _episode_return_mean(rew_l, done_l),
        }


def _episode_return_mean(rewards, dones) -> float:
    returns, cur = [], 0.0
    for r, d in zip(rewards, dones):
        cur += r
        if d:
            returns.append(cur)
            cur = 0.0
    return float(np.mean(returns)) if returns else float(cur)


def softmax_sample(rng, logits: np.ndarray):
    """Sample actions + log-probs from policy logits ([A] or [N, A]): the
    ONE numerically-guarded implementation shared by every runner."""
    logits = np.asarray(logits, np.float64)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    if logits.ndim == 1:
        a = int(rng.choice(len(p), p=p))
        return a, float(np.log(p[a] + 1e-12))
    actions = np.array([rng.choice(p.shape[-1], p=row) for row in p])
    logp = np.log(p[np.arange(len(actions)), actions] + 1e-12)
    return actions, logp.astype(np.float32)


class EpisodeReturns:
    """Per-env episode-return bookkeeping with the EnvRunner semantics:
    the mean over recently finished episodes, falling back to the mean
    PARTIAL return when none finished yet (never a fake 0.0 sentinel)."""

    def __init__(self, num_envs: int, window: int = 20):
        self.partial = np.zeros(num_envs, np.float64)
        self.done = collections.deque(maxlen=window)

    def step(self, env_idx: int, reward: float, done: bool):
        self.partial[env_idx] += reward
        if done:
            self.done.append(self.partial[env_idx])
            self.partial[env_idx] = 0.0

    def mean(self) -> float:
        if self.done:
            return float(np.mean(self.done))
        return float(np.mean(self.partial))
