"""PPO: the Algorithm loop over EnvRunner members + Learner, in PyTorch.

Mirrors ray_tpu/rl/ppo.py (reference rllib/algorithms/ppo/ppo.py:394
training_step + algorithms/algorithm.py:765: sample -> learn -> sync
weights). ``train()`` returns a result dict. The runners come through
``runtime`` (``serve.runtime``'s interface; None: in-process), each on
the CPU (env_runner.py's docstring says why); the learner runs on
``device`` (None: ``cuda``, which raises without a card). With
``num_learners > 1`` the learner is a ``LearnerGroup`` of that many
members through the same runtime, each on ``device``
(rl/learner_group.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ray_tpu_torch.rl.env_runner import RUNNER_DEVICE, EnvRunner
from ray_tpu_torch.rl.learner import Learner, compute_gae
from ray_tpu_torch.rl.learner_group import LearnerGroup
from ray_tpu_torch.serve.runtime import InProcessRuntime


@dataclass
class PPOConfig:
    """Reference: algorithms/algorithm_config.py, flattened."""

    env_creator: Callable | None = None
    obs_dim: int = 4
    n_actions: int = 2
    num_env_runners: int = 2
    rollout_steps: int = 128  # per runner per iteration
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    entropy_coeff: float = 0.01
    sgd_minibatches: int = 4
    sgd_epochs: int = 4
    # >1: distributed LearnerGroup members with a per-minibatch gradient
    # allreduce (rl/learner_group.py)
    num_learners: int = 1
    # env_to_module connector pipeline factory shared by all runners
    # (rl/connectors.py); obs_dim refers to the POST-connector width
    connectors: Callable | None = None

    def build(self, *, runtime=None, device=None) -> "PPO":
        return PPO(self, runtime=runtime, device=device)


class PPO:
    def __init__(self, config: PPOConfig, *, runtime=None, device=None):
        assert config.env_creator is not None, "set PPOConfig.env_creator"
        self.config = config
        self.runtime = runtime or InProcessRuntime()
        if config.num_learners > 1:
            self.learner = LearnerGroup(
                config.obs_dim, config.n_actions,
                num_learners=config.num_learners, lr=config.lr,
                clip=config.clip, entropy_coeff=config.entropy_coeff,
                runtime=self.runtime, device=device)
        else:
            self.learner = Learner(
                config.obs_dim, config.n_actions, lr=config.lr,
                clip=config.clip, entropy_coeff=config.entropy_coeff,
                device=device)
        self.runners = [
            self.runtime.spawn(EnvRunner, dict(
                env_creator=config.env_creator, obs_dim=config.obs_dim,
                n_actions=config.n_actions, seed=i,
                connectors=config.connectors, device=RUNNER_DEVICE),
                name=f"env-runner-{i}")
            for i in range(config.num_env_runners)
        ]
        self._sync_weights()
        self.iteration = 0

    def _sync_weights(self):
        rt = self.runtime
        w = self.learner.get_weights()
        rt.get([rt.call(r, "set_weights", w) for r in self.runners],
               timeout=120)

    def train(self) -> dict:
        """One iteration: parallel sample -> GAE -> minibatch SGD -> sync."""
        cfg = self.config
        rt = self.runtime
        batches = rt.get(
            [rt.call(r, "sample", cfg.rollout_steps) for r in self.runners],
            timeout=600)
        merged = {k: [] for k in ("obs", "actions", "logp", "advantages",
                                  "returns")}
        ep_returns = []
        for b in batches:
            adv, ret = compute_gae(
                b["rewards"], b["values"], b["dones"], b["last_value"],
                gamma=cfg.gamma, lam=cfg.gae_lambda,
            )
            merged["obs"].append(b["obs"])
            merged["actions"].append(b["actions"])
            merged["logp"].append(b["logp"])
            merged["advantages"].append(adv)
            merged["returns"].append(ret)
            ep_returns.append(b["episode_return_mean"])
        batch = {k: np.concatenate(v) for k, v in merged.items()}
        metrics = self.learner.update(
            batch, minibatches=cfg.sgd_minibatches, epochs=cfg.sgd_epochs
        )
        self._sync_weights()
        self.iteration += 1
        metrics["episode_return_mean"] = float(np.mean(ep_returns))
        metrics["training_iteration"] = self.iteration
        return metrics

    def stop(self):
        for r in self.runners:
            try:
                self.runtime.kill(r)
            except Exception:  # noqa: BLE001
                pass
        if isinstance(self.learner, LearnerGroup):
            self.learner.shutdown()
