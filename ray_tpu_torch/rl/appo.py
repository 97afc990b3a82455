"""APPO: asynchronous PPO on the IMPALA actor-learner machinery, in
PyTorch.

Mirrors ray_tpu/rl/appo.py (reference rllib/algorithms/appo/appo.py:1):
IMPALA's architecture (async env-runners, the learner consumes whichever
batch lands first, per-runner weight refresh) with PPO's clipped
surrogate objective over importance-corrected advantages and a TARGET
network whose values bootstrap the V-trace targets. Only
``_build_update`` and ``_apply_batch`` (the target refresh) differ from
IMPALA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.learner import value_and_grad
from ray_tpu_torch.train.optim import apply_updates
from ray_tpu_torch.utils.trees import tree_map


@dataclass
class APPOConfig(IMPALAConfig):
    clip: float = 0.2
    # learner steps between target-network refreshes (reference
    # appo.py target_update_frequency)
    target_update_freq: int = 8

    def build(self, *, runtime=None, device=None) -> "APPO":
        return APPO(self, runtime=runtime, device=device)


class APPO(IMPALA):
    def __init__(self, config: APPOConfig, *, runtime=None, device=None):
        super().__init__(config, runtime=runtime, device=device)
        # target network: value bootstrap source (reference
        # appo_torch_policy's target model)
        self.target_params = tree_map(torch.clone, self.params)
        self._steps_since_target = 0

    def _build_update(self):
        from ray_tpu_torch.rl.vtrace import vtrace

        cfg = self.config

        def _loss(params, target, batch):
            logp, values, logp_all = self._policy_logp_values(
                params, batch)
            # value targets bootstrap from the TARGET network: the
            # regression target must not chase the online critic
            with torch.no_grad():
                _, target_values, _ = self._policy_logp_values(target, batch)
            vs, adv = vtrace(
                batch["logp"], logp.detach(),
                batch["rewards"], target_values,
                batch["last_values"], batch["dones"],
                gamma=cfg.gamma, lam=cfg.vtrace_lam,
                rho_bar=cfg.rho_bar, c_bar=cfg.c_bar,
            )
            # PPO clipped surrogate against the BEHAVIOUR policy's logp
            # (the batch was sampled under slightly stale weights; the
            # clip bounds how far the update exploits that gap)
            ratio = torch.exp(logp - batch["logp"])
            pg = -torch.mean(torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv,
            ))
            vf = torch.mean((values - vs) ** 2)
            ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
            total = pg + cfg.vf_coeff * vf - cfg.entropy_coeff * ent
            return total, {"policy_loss": pg, "vf_loss": vf,
                           "entropy": ent, "total_loss": total,
                           "mean_ratio": torch.mean(ratio)}

        def _update(params, target, opt_state, batch):
            (_, metrics), grads = value_and_grad(_loss, params, target, batch)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            return params, opt_state, metrics

        return _update

    def _apply_batch(self, jb) -> dict:
        self.params, self.opt_state, metrics = self._update(
            self.params, self.target_params, self.opt_state, jb)
        self._steps_since_target += 1
        if self._steps_since_target >= self.config.target_update_freq:
            self.target_params = tree_map(torch.clone, self.params)
            self._steps_since_target = 0
        return metrics
