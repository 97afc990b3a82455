"""Learner: the PPO update, in PyTorch.

Mirrors ray_tpu/rl/learner.py (reference rllib/core/learner/
learner.py:111): minibatch PPO with a clipped objective, value loss and
entropy bonus. JAX's ``jax.jit(jax.value_and_grad(...))`` is
:func:`value_and_grad` over a params tree of tensors (autograd), and
``optax.adam`` is ``train.optim.adam``, which follows optax's order of
operations. The learner runs on ``device`` (None: ``cuda``, which raises
without a card); batches arrive as numpy and move there per minibatch.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.train.optim import adam, apply_updates
from ray_tpu_torch.utils.trees import tree_leaves, tree_unflatten

_BATCH_KEYS = ("obs", "actions", "logp", "advantages", "returns")


def compute_gae(rewards, values, dones, last_value, *, gamma=0.99,
                lam=0.95):
    """Generalized advantage estimation (host-side, numpy)."""
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    last_gae = 0.0
    next_value = last_value
    for t in reversed(range(n)):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


def normalize_advantages(batch: dict) -> dict:
    """Batch-level advantage normalization (once, before any sharding)."""
    adv = np.asarray(batch["advantages"], np.float32)
    out = dict(batch)
    out["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
    return out


def value_and_grad(loss_fn, params, *args, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    ``loss_fn(params, ...) -> (loss, aux)``; returns ((loss, aux), grads)
    with grads a tree like ``params`` and everything detached. Leaves
    the loss does not reach get zero gradients, as in JAX."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args, **kwargs)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
           for k, v in aux.items()}
    return (loss.detach(), aux), tree_unflatten(params, grads)


def batch_to(batch: dict, keys, device) -> dict:
    """The named numpy columns of a batch as tensors on ``device``: floats
    as f32 (as ``jnp.asarray`` makes them), ints as int64 (the index
    dtype of ``gather``), bools as they are."""
    out = {}
    for k in keys:
        a = np.asarray(batch[k])
        dtype = {"f": torch.float32, "i": torch.int64,
                 "u": torch.int64}.get(a.dtype.kind, torch.bool)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return out


class Learner:
    """Owns params + optimizer state on ``device``.

    ``module`` is any RLModule (rl_module.py): the loss consumes only its
    forward_train contract. ``seed`` draws the init on the CPU, so a
    learner on the card and one on the CPU start from the same weights."""

    def __init__(self, obs_dim: int, n_actions: int, *, lr=3e-4,
                 clip=0.2, vf_coeff=0.5, entropy_coeff=0.01, seed=0,
                 module=None, device=None):
        from ray_tpu_torch.rl.rl_module import DiscretePolicyModule

        self.device = resolve_device(device)
        self.module = module or DiscretePolicyModule(obs_dim, n_actions)
        self.params = self.module.init(seed, device=self.device)
        self.opt = adam(lr)
        self.opt_state = self.opt.init(self.params)
        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff

    def _loss(self, params, batch):
        out = self.module.forward_train(params, batch["obs"])
        logits, value = out["logits"], out["vf"]
        logp_all = torch.log_softmax(logits, dim=1)
        logp = logp_all.gather(1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        # advantages arrive batch-normalized (normalize_advantages at the
        # update level), as in JAX
        adv = batch["advantages"]
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv,
        ).mean()
        vf = torch.mean((value - batch["returns"]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=1))
        total = pg + self.vf_coeff * vf - self.entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf,
                       "entropy": entropy}

    def grad_fn(self, params, batch):
        """(grads, metrics) of one minibatch: the per-shard step of a
        learner group."""
        (loss, metrics), grads = value_and_grad(self._loss, params, batch)
        metrics["total_loss"] = loss
        return grads, metrics

    def _update(self, params, opt_state, batch):
        grads, metrics = self.grad_fn(params, batch)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, metrics

    def update(self, batch: dict, *, minibatches: int = 4,
               epochs: int = 4, shuffle_seed: int = 0) -> dict:
        batch = normalize_advantages(batch)
        return run_sgd(self, batch, minibatches=minibatches,
                       epochs=epochs, shuffle_seed=shuffle_seed)

    def get_weights(self):
        """The params as CPU tensors."""
        return models.to_host(self.params)


def run_sgd(learner: Learner, batch: dict, *, minibatches: int,
            epochs: int, shuffle_seed: int, grad_hook=None) -> dict:
    """THE epoch/shuffle/minibatch/apply loop, as JAX's: the same shuffle
    RNG (``np.random.RandomState(shuffle_seed)``), the same slicing
    (``np.array_split``), the same optimizer application; advantage
    normalization is the caller's job, once.

    grad_hook(grads, n_rows) -> grads runs between the gradient and the
    optimizer step (a learner group's allreduce seam)."""
    n = len(batch["obs"])
    idx = np.arange(n)
    metrics = {}
    rng = np.random.RandomState(shuffle_seed)
    for _ in range(epochs):
        rng.shuffle(idx)
        for mb in np.array_split(idx, minibatches):
            sub = batch_to({k: np.asarray(batch[k])[mb] for k in _BATCH_KEYS},
                           _BATCH_KEYS, learner.device)
            if grad_hook is None:
                learner.params, learner.opt_state, metrics = (
                    learner._update(learner.params, learner.opt_state,
                                    sub))
            else:
                grads, metrics = learner.grad_fn(learner.params, sub)
                grads = grad_hook(grads, len(mb))
                updates, learner.opt_state = learner.opt.update(
                    grads, learner.opt_state, learner.params)
                learner.params = apply_updates(learner.params, updates)
    return {k: float(v) for k, v in metrics.items()}
