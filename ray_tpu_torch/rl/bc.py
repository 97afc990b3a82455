"""Offline RL: behavior cloning from a dataset of transitions, in PyTorch.

Mirrors ray_tpu/rl/bc.py (reference rllib/offline/ +
algorithms/bc/bc.py): learn a policy by supervised imitation of logged
(obs, action) pairs, no environment interaction. The dataset is any
object with ``random_shuffle(seed=...)`` and ``iter_batches()`` yielding
lists of rows {"obs": [...], "action": int} (ray_tpu.data's Dataset has
both); the cross-entropy update is :meth:`BC._update` on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.learner import value_and_grad
from ray_tpu_torch.train.optim import adam, apply_updates


@dataclass
class BCConfig:
    obs_dim: int = 4
    n_actions: int = 2
    lr: float = 1e-3
    epochs: int = 5
    batch_size: int = 128
    seed: int = 0

    def build(self, device=None) -> "BC":
        return BC(self, device=device)


class BC:
    def __init__(self, config: BCConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.params = models.init_policy(
            config.seed, config.obs_dim, config.n_actions, device=self.device)
        self.opt = adam(config.lr)
        self.opt_state = self.opt.init(self.params)
        self.iteration = 0

    @staticmethod
    def _loss(p, obs, actions):
        logits = models.forward(p, obs)[0]
        logp = torch.log_softmax(logits, dim=1)
        nll = -logp.gather(1, actions[:, None])
        acc = torch.mean((torch.argmax(logits, dim=1) == actions).float())
        return torch.mean(nll), {"acc": acc}

    def _update(self, params, opt_state, obs, actions):
        (loss, aux), grads = value_and_grad(self._loss, params, obs, actions)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss, aux["acc"]

    def train_on_dataset(self, dataset) -> dict:
        """Run `epochs` passes of minibatch SGD over the dataset."""
        c = self.config
        loss = acc = 0.0
        for _ in range(c.epochs):
            shuffled = dataset.random_shuffle(seed=c.seed + self.iteration)
            for block in shuffled.iter_batches():
                rows = block if isinstance(block, list) else list(block)
                obs = torch.from_numpy(np.asarray(
                    [r["obs"] for r in rows], np.float32)).to(self.device)
                actions = torch.from_numpy(np.asarray(
                    [r["action"] for r in rows], np.int64)).to(self.device)
                for lo in range(0, len(rows), c.batch_size):
                    sl = slice(lo, lo + c.batch_size)
                    self.params, self.opt_state, loss, acc = self._update(
                        self.params, self.opt_state, obs[sl], actions[sl])
            self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "loss": float(loss),
            "train_accuracy": float(acc),
        }

    @torch.no_grad()
    def compute_actions(self, obs) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        logits = models.forward(self.params, x)[0]
        return torch.argmax(logits, dim=1).cpu().numpy()
