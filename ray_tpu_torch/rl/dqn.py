"""DQN: off-policy Q-learning over QEnvRunner members + replay, in PyTorch.

Mirrors ray_tpu/rl/dqn.py (reference rllib/algorithms/dqn/ (dqn.py
training_step, the replay + target-network pattern)): the double-DQN TD
update (target = r + γ·(1-d)·Q_tgt(s', argmax_a Q(s',a)), Huber loss)
is :meth:`DQN._update_fn` over the policy tree with autograd on the
learner's ``device`` (None: ``cuda``, which raises without a card), and
``optax.adam`` is ``train.optim.adam``. The ε-greedy runners come
through ``runtime`` (``serve.runtime``'s interface; None: in-process),
each on the CPU as in JAX (env_runner.py's docstring says why); their
exploration is numpy ``RandomState``, so from the same weights and seed
the port's runners take the same actions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env_runner import RUNNER_DEVICE, _episode_return_mean
from ray_tpu_torch.rl.learner import batch_to, value_and_grad
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.train.optim import adam, apply_updates
from ray_tpu_torch.utils.trees import tree_map

_BATCH_KEYS = ("obs", "actions", "rewards", "dones", "next_obs")


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss(x)`` elementwise, written as optax writes it:
    0.5·x² where |x| ≤ δ, else 0.5·δ² + δ·(|x| − δ)."""
    abs_x = torch.abs(x)
    quadratic = torch.minimum(abs_x, torch.full_like(abs_x, delta))
    # the same as max(|x| - delta, 0) without doubling the gradient
    linear = abs_x - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


class QEnvRunner:
    """ε-greedy sampling member (rollout_worker.py analog for DQN). JAX
    pins it to the CPU; the algorithm passes ``RUNNER_DEVICE``."""

    def __init__(self, env_creator, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = env_creator()
        self.rng = np.random.RandomState(seed)
        self._obs = np.asarray(self.env.reset(), np.float32)
        self.params = None

    def set_weights(self, params):
        self.params = models.as_tensors(params, self.device)
        return True

    @torch.no_grad()
    def _q(self, obs: np.ndarray) -> np.ndarray:
        return models.forward(
            self.params, torch.from_numpy(obs).to(self.device))[0].cpu().numpy()

    def sample(self, n_steps: int, epsilon: float) -> dict:
        obs_l, act_l, rew_l, done_l, next_l = [], [], [], [], []
        obs = self._obs
        for _ in range(n_steps):
            q = self._q(obs[None])[0]
            a = (int(self.rng.randint(len(q)))
                 if self.rng.rand() < epsilon else int(np.argmax(q)))
            nxt, r, done, _ = self.env.step(a)
            nxt = np.asarray(nxt, np.float32)
            obs_l.append(obs)
            act_l.append(a)
            rew_l.append(float(r))
            done_l.append(bool(done))
            next_l.append(nxt)
            obs = (np.asarray(self.env.reset(), np.float32) if done
                   else nxt)
        self._obs = obs
        return {
            "obs": np.stack(obs_l),
            "actions": np.asarray(act_l, np.int32),
            "rewards": np.asarray(rew_l, np.float32),
            "dones": np.asarray(done_l, np.bool_),
            "next_obs": np.stack(next_l),
            "episode_return_mean": _episode_return_mean(rew_l, done_l),
        }


@dataclass
class DQNConfig:
    env_creator: Callable | None = None
    obs_dim: int = 4
    n_actions: int = 2
    num_env_runners: int = 2
    rollout_steps: int = 64           # per runner per iteration
    buffer_capacity: int = 50_000
    learning_starts: int = 256
    train_batch_size: int = 64
    grad_steps_per_iteration: int = 32
    lr: float = 5e-4
    gamma: float = 0.99
    target_update_period: int = 4     # iterations between hard syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iterations: int = 30
    seed: int = 0

    def build(self, *, runtime=None, device=None) -> "DQN":
        return DQN(self, runtime=runtime, device=device)


class DQN:
    def __init__(self, config: DQNConfig, *, runtime=None, device=None):
        assert config.env_creator is not None, "set DQNConfig.env_creator"
        self.config = config
        self.device = resolve_device(device)
        self.runtime = runtime or InProcessRuntime()
        self.params = models.init_policy(
            config.seed, config.obs_dim, config.n_actions, device=self.device)
        self.target_params = tree_map(torch.clone, self.params)
        self.opt = adam(config.lr)
        self.opt_state = self.opt.init(self.params)
        self.buffer = ReplayBuffer(
            config.buffer_capacity, config.obs_dim, seed=config.seed)
        self.runners = [
            self.runtime.spawn(QEnvRunner, dict(
                env_creator=config.env_creator, seed=config.seed + i,
                device=RUNNER_DEVICE), name=f"q-env-runner-{i}")
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0
        self._sync_runner_weights()

    def _sync_runner_weights(self):
        rt = self.runtime
        w = models.to_host(self.params)
        rt.get([rt.call(r, "set_weights", w) for r in self.runners],
               timeout=120)

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self.iteration / max(1, c.epsilon_decay_iterations))
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def _update_fn(self, params, target_params, opt_state, batch):
        """One double-DQN step on a batch of tensors on the learner's
        device: (params, opt_state, loss, mean |td|)."""
        c = self.config

        def loss_fn(p):
            q = models.forward(p, batch["obs"])[0]
            q_sa = q.gather(1, batch["actions"][:, None])[:, 0]
            # double DQN: online net picks a', target net evaluates it
            next_online = models.forward(p, batch["next_obs"])[0]
            a_prime = torch.argmax(next_online, dim=1)
            next_target = models.forward(target_params, batch["next_obs"])[0]
            q_next = next_target.gather(1, a_prime[:, None])[:, 0]
            target = batch["rewards"] + c.gamma * (
                1.0 - batch["dones"].to(torch.float32)) * q_next.detach()
            td = q_sa - target
            return torch.mean(huber_loss(td)), {"td_abs": torch.mean(td.abs())}

        (loss, aux), grads = value_and_grad(loss_fn, params)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss, aux["td_abs"]

    def train(self) -> dict:
        c = self.config
        rt = self.runtime
        eps = self._epsilon()
        batches = rt.get(
            [rt.call(r, "sample", c.rollout_steps, eps) for r in self.runners],
            timeout=600)
        for b in batches:
            self.buffer.add_batch(
                b["obs"], b["actions"], b["rewards"], b["dones"],
                b["next_obs"],
            )
        loss = td = 0.0
        if len(self.buffer) >= c.learning_starts:
            for _ in range(c.grad_steps_per_iteration):
                mb = batch_to(self.buffer.sample(c.train_batch_size),
                              _BATCH_KEYS, self.device)
                self.params, self.opt_state, loss, td = self._update_fn(
                    self.params, self.target_params, self.opt_state, mb)
        self.iteration += 1
        if self.iteration % c.target_update_period == 0:
            self.target_params = tree_map(torch.clone, self.params)
        self._sync_runner_weights()
        return {
            "training_iteration": self.iteration,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            "loss": float(loss),
            "td_error_mean": float(td),
            "episode_return_mean": float(np.mean(
                [b["episode_return_mean"] for b in batches]
            )),
        }

    def stop(self):
        for r in self.runners:
            try:
                self.runtime.kill(r)
            except Exception:  # noqa: BLE001
                pass
