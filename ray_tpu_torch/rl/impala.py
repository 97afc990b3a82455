"""IMPALA: asynchronous actor-learner architecture with V-trace, in PyTorch.

Mirrors ray_tpu/rl/impala.py (reference rllib/algorithms/impala/
impala.py + the Espeholt et al. architecture): sampling never blocks on
learning. Every runner always has a sample request in flight; the
learner consumes whichever batch lands first (the runtime's ``wait``),
applies a V-trace-corrected update (the batch was collected under a
slightly stale policy: that's the point), and refreshes only that
runner's weights.

The update is one Python function over [T, N] trajectories (V-trace a
reverse loop, autograd for the gradient, ``train.optim.adam``) on
``device`` (None: ``cuda``, which raises without a card); runners step
vectorized envs on the CPU through ``runtime`` (None: in-process).
``_policy_logp_values`` / ``_build_update`` / ``_apply_batch`` are the
seams APPO overrides, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env_runner import RUNNER_DEVICE
from ray_tpu_torch.rl.learner import batch_to, value_and_grad
from ray_tpu_torch.rl.vector_env import VectorEnvRunner
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.train.optim import adam, apply_updates

_BATCH_KEYS = ("obs", "actions", "logp", "values", "rewards", "dones",
               "last_values")


@dataclass
class IMPALAConfig:
    env_creator: Callable | None = None
    obs_dim: int = 4
    n_actions: int = 2
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_steps: int = 32  # T per sample request
    lr: float = 3e-4
    gamma: float = 0.99
    vtrace_lam: float = 1.0
    rho_bar: float = 1.0
    c_bar: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    # an RLModule (rl_module.py); None -> DiscretePolicyModule. Must be
    # runner-compatible: VectorEnvRunner forwards with the MLP policy
    # nets, so only DiscretePolicyModule param trees can be pushed to
    # runners (the constructor enforces this).
    module: object | None = None

    def build(self, *, runtime=None, device=None) -> "IMPALA":
        return IMPALA(self, runtime=runtime, device=device)


class IMPALA:
    def __init__(self, config: IMPALAConfig, *, runtime=None, device=None):
        from ray_tpu_torch.rl.rl_module import DiscretePolicyModule

        assert config.env_creator is not None
        self.config = config
        cfg = config
        if cfg.module is not None and not isinstance(
                cfg.module, DiscretePolicyModule):
            raise ValueError(
                "IMPALA/APPO push the learner's weights to "
                "VectorEnvRunner, which samples with the MLP policy "
                "nets: config.module must be a DiscretePolicyModule "
                f"(got {type(cfg.module).__name__})")
        self.device = resolve_device(device)
        self.runtime = runtime or InProcessRuntime()
        self.module = cfg.module or DiscretePolicyModule(
            cfg.obs_dim, cfg.n_actions)
        self.params = self.module.init(0, device=self.device)
        self.opt = adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self._update = self._build_update()

        rt = self.runtime
        self.runners = [
            rt.spawn(VectorEnvRunner, dict(
                env_creator=cfg.env_creator, obs_dim=cfg.obs_dim,
                n_actions=cfg.n_actions, num_envs=cfg.num_envs_per_runner,
                seed=i, device=RUNNER_DEVICE), name=f"vector-runner-{i}")
            for i in range(cfg.num_env_runners)
        ]
        w = models.to_host(self.params)
        rt.get([rt.call(r, "set_weights", w) for r in self.runners],
               timeout=120)
        # the async pipeline: one sample request ALWAYS in flight per
        # runner; wait() returns the identical ref objects, so identity
        # keys work
        self._inflight = {
            rt.call(r, "sample", cfg.rollout_steps): r for r in self.runners
        }
        self.iteration = 0

    def _policy_logp_values(self, params, batch):
        """[T, N] logp of taken actions, values, and full log-softmax,
        shared by the IMPALA and APPO losses (module contract)."""
        t, n = batch["actions"].shape
        flat_obs = batch["obs"].reshape(t * n, -1)
        out = self.module.forward_train(params, flat_obs)
        logits = out["logits"].reshape(t, n, -1)
        values = out["vf"].reshape(t, n)
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
        return logp, values, logp_all

    def _build_update(self):
        """Return the (params, opt_state, batch) -> update fn. APPO
        overrides this seam with its clipped off-policy loss."""
        from ray_tpu_torch.rl.vtrace import vtrace

        cfg = self.config

        def _loss(params, batch):
            logp, values, logp_all = self._policy_logp_values(
                params, batch)
            vs, adv = vtrace(
                batch["logp"], logp, batch["rewards"], values,
                batch["last_values"], batch["dones"],
                gamma=cfg.gamma, lam=cfg.vtrace_lam,
                rho_bar=cfg.rho_bar, c_bar=cfg.c_bar,
            )
            pg = -torch.mean(logp * adv)
            vf = torch.mean((values - vs) ** 2)
            ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
            total = pg + cfg.vf_coeff * vf - cfg.entropy_coeff * ent
            return total, {"policy_loss": pg, "vf_loss": vf,
                           "entropy": ent, "total_loss": total}

        def _update(params, opt_state, batch):
            (_, metrics), grads = value_and_grad(_loss, params, batch)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            return params, opt_state, metrics

        return _update

    def batch_to_device(self, batch: dict) -> dict:
        """A sample batch (numpy, as the runners return it) as tensors on
        the learner's device (JAX's ``jnp.asarray`` of each column)."""
        return batch_to(batch, _BATCH_KEYS, self.device)

    def _apply_batch(self, jb) -> dict:
        """Apply one landed sample batch (APPO overrides: target net)."""
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, jb)
        return metrics

    def train(self) -> dict:
        """Consume batches as they land for one learner round
        (num_env_runners updates), never blocking sampling."""
        cfg = self.config
        rt = self.runtime
        metrics = {}
        ep_means = []
        for _ in range(len(self.runners)):
            ready, pending = rt.wait(
                list(self._inflight), num_returns=1, timeout=600)
            if not ready:
                raise TimeoutError(
                    f"no sample batch arrived in 600s; {len(pending)} "
                    "runner(s) unresponsive (dead member or hung env)")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            batch = rt.get(ref, timeout=120)
            ep_means.append(batch.pop("episode_return_mean"))
            metrics = self._apply_batch(self.batch_to_device(batch))
            # refresh ONLY this runner, then immediately re-arm it:
            # sampling continues under the fresh (or slightly stale for
            # others) policy; V-trace absorbs the lag
            rt.call(runner, "set_weights", models.to_host(self.params))
            self._inflight[
                rt.call(runner, "sample", cfg.rollout_steps)] = runner
        self.iteration += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["episode_return_mean"] = float(np.mean(ep_means))
        out["training_iteration"] = self.iteration
        return out

    def stop(self):
        for r in self.runners:
            try:
                self.runtime.kill(r)
            except Exception:  # noqa: BLE001
                pass
