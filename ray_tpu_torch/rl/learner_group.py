"""LearnerGroup: distributed PPO and SAC learning across learner members,
in PyTorch.

Mirrors ray_tpu/rl/learner_group.py (reference rllib/core/learner/
learner_group.py:61 (+ :225 _distributed_update)): N learner members
each hold a replica of the policy, take a shard of every SGD minibatch,
and allreduce gradients so every replica applies the IDENTICAL update.
The whole gradient tree is packed into one contiguous f32 vector per
step — one collective per minibatch, not one per parameter.

The members and their collective come through ``runtime``
(``serve.runtime``'s interface; None: in-process): ``spawn`` makes each
member, ``collective(members, group_name)`` returns one allreduce
callable per rank, and ``join_group`` hands each member its own, which
it calls from inside its update. JAX makes the members ray_tpu actors in
a collective group (``create_collective_group``) and sums over its ring;
the port's runtimes give the ring of ``ray_tpu_torch/collective/`` (op
``sum``): ``InProcessRuntime`` over mailboxes of this process,
``ProcessRuntime`` over sockets between the member processes, and a
hosting runtime over ``ray_tpu.collective``. ``collective_stats()`` is a
member's last collective's wire accounting.

Placement: each member's learner runs on ``device``, which the group
passes through (None: ``cuda``, which raises without a card), as the
port's single ``Learner`` does. JAX pins ``LearnerActor`` to the CPU
(ray_tpu/rl/learner_group.py:120) only because a TPU host's chips belong
to one process; the in-process runtime's members are threads of one
process and share the card.

With identical seeds and row-weighted mean gradients, an N-learner
group's update equals the single Learner's update on the full batch.
"""

from __future__ import annotations

import uuid

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.learner import Learner, normalize_advantages, run_sgd
from ray_tpu_torch.rl.sac import SACLearner
from ray_tpu_torch.serve.runtime import InProcessRuntime, spawn_at_once
from ray_tpu_torch.utils.trees import tree_leaves, tree_unflatten


def allreduce_grads_rowmean(grads, n_rows: int, allreduce):
    """Row-weighted mean of a gradient tree across a collective group,
    packed as ONE contiguous f32 vector (one collective per step, not
    one per parameter); ``allreduce`` is the member's callable from the
    runtime's ``collective``.

    Each replica's gradient is a mean over its (possibly unequal) shard;
    weighting by row count makes the result equal the mean over the
    UNION — the full-batch gradient. The row count rides as the vector's
    last element, so one allreduce carries both. Shared by the PPO and
    SAC learner members."""
    leaves = tree_leaves(grads)
    flat = np.concatenate(
        [x.detach().to("cpu", torch.float32).numpy().ravel() for x in leaves]
        + [np.float32([1.0])])
    flat[:-1] *= n_rows
    flat[-1] = n_rows
    summed = np.asarray(allreduce(flat), np.float32)
    total_rows = summed[-1]
    summed = summed[:-1] / total_rows
    out, off = [], 0
    for x in leaves:
        size = x.numel()
        out.append(torch.from_numpy(summed[off:off + size].reshape(x.shape))
                   .to(x.device, x.dtype))
        off += size
    return tree_unflatten(grads, out)


class _GroupMemberMixin:
    """join_group bookkeeping shared by the PPO and SAC learner members."""

    _allreduce = None
    _world = 1

    def join_group(self, world_size: int, rank: int, allreduce):
        # the runtime's collective made ``allreduce``; this records it
        # for the update loop
        self._allreduce = allreduce
        self._world = world_size
        return True

    def collective_stats(self):
        """The ``OpStats`` of this member's last collective (None before
        the first, or for a callable that keeps none)."""
        stats = getattr(self._allreduce, "stats", None)
        return None if stats is None else stats()

    def _grad_hook(self):
        if self._allreduce is None or self._world <= 1:
            return None

        def hook(grads, n_rows):
            return allreduce_grads_rowmean(grads, n_rows, self._allreduce)
        return hook


class _LearnerGroupBase:
    """Driver-side group scaffolding shared by LearnerGroup (PPO) and
    SACLearnerGroup: collective bootstrap, shard-size guard, weights,
    teardown (reference learner_group.py:61)."""

    _GROUP_PREFIX = "learner_group"

    def _bootstrap(self, runtime, cls, kwargs: dict,
                   num_learners: int) -> None:
        self.runtime = runtime or InProcessRuntime()
        self.num_learners = num_learners
        self.learners = spawn_at_once(self.runtime, [
            (cls, dict(kwargs), {"name": f"{cls.__name__}-{r}"})
            for r in range(num_learners)])
        if num_learners > 1:
            rt = self.runtime
            # unique, so that the groups of two drivers (or of JAX's
            # learner groups, which count from 1) on one cluster never meet
            group = f"{self._GROUP_PREFIX}_{uuid.uuid4().hex[:12]}"
            reducers = rt.collective(self.learners, group)
            rt.get([rt.call(a, "join_group", num_learners, r, fn)
                    for r, (a, fn) in enumerate(zip(self.learners,
                                                    reducers))],
                   timeout=120)

    def _check_shardable(self, n: int) -> None:
        if n < self.num_learners:
            # an empty shard's mean-loss is NaN and the row-weighted
            # allreduce (NaN * 0) would poison every replica's weights
            raise ValueError(
                f"batch of {n} rows cannot shard across "
                f"{self.num_learners} learners")

    def _shard_calls(self, batch: dict, method: str, **kwargs) -> list:
        """Each member's ``method`` on its ``array_split`` shard of the
        batch's rows; returns every member's reply, in rank order."""
        rt = self.runtime
        shards = np.array_split(np.arange(len(batch["obs"])),
                                self.num_learners)
        refs = [rt.call(a, method,
                        {k: np.asarray(batch[k])[s] for k in batch},
                        **kwargs)
                for s, a in zip(shards, self.learners)]
        return rt.get(refs, timeout=600)

    def get_weights(self):
        return self.runtime.get(
            self.runtime.call(self.learners[0], "get_weights"), timeout=120)

    def shutdown(self):
        for a in self.learners:
            try:
                self.runtime.kill(a)
            except Exception:  # noqa: BLE001
                pass


class LearnerActor(_GroupMemberMixin):
    """One learner replica (reference learner_group.py worker)."""

    def __init__(self, obs_dim: int, n_actions: int, seed: int = 0,
                 device=None, **learner_kwargs):
        self.learner = Learner(obs_dim, n_actions, seed=seed, device=device,
                               **learner_kwargs)

    def update_shard(self, batch: dict, *, minibatches: int = 4,
                     epochs: int = 4, shuffle_seed: int = 0) -> dict:
        """SGD over THIS learner's shard of the batch via the SHARED
        run_sgd loop; gradients are row-weighted-mean-allreduced across
        the group before every optimizer step, so all replicas apply the
        identical full-batch-equivalent update even with unequal shard
        sizes."""
        return run_sgd(self.learner, batch, minibatches=minibatches,
                       epochs=epochs, shuffle_seed=shuffle_seed,
                       grad_hook=self._grad_hook())

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params):
        self.learner.params = models.as_tensors(params, self.learner.device)
        return True


class LearnerGroup(_LearnerGroupBase):
    """Driver-side facade (reference learner_group.py:61)."""

    def __init__(self, obs_dim: int, n_actions: int, *,
                 num_learners: int = 2, seed: int = 0, runtime=None,
                 device=None, **learner_kwargs):
        self._bootstrap(runtime, LearnerActor, dict(
            obs_dim=obs_dim, n_actions=n_actions, seed=seed,
            device=resolve_device(device),
            **learner_kwargs), num_learners)

    def update(self, batch: dict, *, minibatches: int = 4,
               epochs: int = 4, shuffle_seed: int = 0) -> dict:
        """Shard the batch across learners (``array_split`` of the rows)
        and run the lockstep distributed update."""
        batch = normalize_advantages(batch)  # once, BEFORE sharding
        self._check_shardable(len(batch["obs"]))
        return self._shard_calls(batch, "update_shard",
                                 minibatches=minibatches, epochs=epochs,
                                 shuffle_seed=shuffle_seed)[0]

    def set_weights(self, params):
        rt = self.runtime
        rt.get([rt.call(a, "set_weights", params) for a in self.learners],
               timeout=120)


class SACLearnerActor(_GroupMemberMixin):
    """One SAC learner replica (continuous control; rl/sac.py)."""

    def __init__(self, obs_dim: int, action_dim: int, seed: int = 0,
                 device=None, **learner_kwargs):
        self.learner = SACLearner(obs_dim, action_dim, seed=seed,
                                  device=device, **learner_kwargs)

    def update_shard(self, batch: dict) -> dict:
        """One SAC step on THIS replica's shard. The driver drew the
        reparameterization noise on the FULL batch and sliced it with the
        rows (sac.py sample_action_with_noise), so the row-weighted
        allreduced gradient equals the full-batch gradient and every
        replica applies the identical update."""
        return {k: float(v) for k, v in self.learner.update(
            batch, grad_hook=self._grad_hook()).items()}

    def get_weights(self):
        return self.learner.get_weights()

    def act_deterministic(self, obs):
        return self.learner.act(obs, deterministic=True).cpu().numpy()


class SACLearnerGroup(_LearnerGroupBase):
    """Distributed SAC learning (the continuous-control LearnerGroup —
    reference learner_group.py:61 with SACLearner replicas). Noise is
    drawn ONCE per update on the driver, from a ``torch.Generator``
    seeded ``seed + 1`` as a single SACLearner's is, and sharded with the
    batch rows, making the N-replica update equal the single-learner
    update on the full batch."""

    _GROUP_PREFIX = "sac_learner_group"

    def __init__(self, obs_dim: int, action_dim: int, *,
                 num_learners: int = 2, seed: int = 0, runtime=None,
                 device=None, **learner_kwargs):
        self.action_dim = action_dim
        self._gen = torch.Generator().manual_seed(seed + 1)
        self._bootstrap(runtime, SACLearnerActor, dict(
            obs_dim=obs_dim, action_dim=action_dim, seed=seed,
            device=resolve_device(device), **learner_kwargs), num_learners)

    def update(self, batch: dict) -> dict:
        """Draw full-batch noise, shard rows + noise, run the lockstep
        distributed step."""
        self._check_shardable(len(batch["obs"]))
        batch = dict(batch)
        if "noise_pi" not in batch:  # caller-provided noise wins (tests)
            n = len(batch["obs"])
            batch["noise_pi"] = torch.randn(
                (n, self.action_dim), generator=self._gen).numpy()
            batch["noise_next"] = torch.randn(
                (n, self.action_dim), generator=self._gen).numpy()
        return self._shard_calls(batch, "update_shard")[0]
