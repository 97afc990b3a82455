"""SAC: off-policy continuous control with a tanh-squashed Gaussian
policy, twin critics, and learned entropy temperature, in PyTorch.

Mirrors ray_tpu/rl/sac.py (reference rllib/algorithms/sac/sac.py:1 +
sac_torch_policy.py's actor/critic/alpha losses): the whole update —
twin-Q Bellman regression against the entropy-regularized target,
reparameterized actor loss through min(Q1,Q2), alpha loss against the
entropy target, and the polyak target blend — runs over a single params
tree of tensors on the learner's ``device`` (None: ``cuda``, which
raises without a card). The tree keeps JAX's keys and shapes, so
``models.from_jax_params`` carries a JAX tree across. JAX's
``stop_gradient`` is ``detach()``; ``optax.multi_transform`` over the
labels is two ``train.optim.adam`` states, one over ``actor`` at ``lr``
and one over ``q1``, ``q2`` and ``log_alpha`` at ``lr_critic or 3·lr``.
Noise comes from ``torch.Generator``s where JAX draws from keys, so the
same seed gives other numbers; the update takes the noise in the batch
(``noise_pi`` / ``noise_next``) for a caller that needs it fixed.
Sampling members run the squashed Gaussian on the CPU through a
connector pipeline (obs normalization, action clipping —
rl/connectors.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import connectors as _conn
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env_runner import RUNNER_DEVICE, EpisodeReturns
from ray_tpu_torch.rl.learner import batch_to, value_and_grad
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.train.optim import adam, apply_updates
from ray_tpu_torch.utils.trees import tree_map

LOG_STD_MIN, LOG_STD_MAX = -8.0, 2.0
ACTOR_KEYS = ("actor",)  # optax.multi_transform's "actor" label
CRITIC_KEYS = ("log_alpha", "q1", "q2")  # its "critic" label
_BATCH_KEYS = ("obs", "actions", "rewards", "dones", "next_obs",
               "noise_pi", "noise_next")


# ---------------- continuous-control networks ----------------

def init_sac_params(seed, obs_dim: int, action_dim: int,
                    hidden: int = 128, device=None) -> dict:
    """JAX's tree (``actor``: h1, h2, mu, log_std; ``q1``/``q2``: h1, h2,
    out; ``log_alpha`` a scalar 0), each dense layer N(0, 1/in), drawn in
    that order from ``seed`` (an int draws on the CPU)."""
    dev = resolve_device(device)
    gen = models.generator(seed)
    actor = {
        "h1": models.dense(gen, obs_dim, hidden, dev),
        "h2": models.dense(gen, hidden, hidden, dev),
        "mu": models.dense(gen, hidden, action_dim, dev),
        "log_std": models.dense(gen, hidden, action_dim, dev),
    }

    def q_net():
        return {
            "h1": models.dense(gen, obs_dim + action_dim, hidden, dev),
            "h2": models.dense(gen, hidden, hidden, dev),
            "out": models.dense(gen, hidden, 1, dev),
        }

    return {
        "actor": actor,
        "q1": q_net(),
        "q2": q_net(),
        # alpha = exp(log_alpha), learned against the entropy target
        "log_alpha": torch.zeros((), dtype=torch.float32, device=dev),
    }


def _mlp(p, x):
    # relu, not tanh: critics regress onto returns whose magnitude is
    # reward_scale-dependent; bounded features throttle how fast the
    # linear head can reach large targets
    h = torch.relu(x @ p["h1"]["w"] + p["h1"]["b"])
    return torch.relu(h @ p["h2"]["w"] + p["h2"]["b"])


def actor_dist(actor, obs):
    """obs [B, O] -> (mu [B, A], log_std [B, A]) pre-squash."""
    h = _mlp(actor, obs)
    mu = h @ actor["mu"]["w"] + actor["mu"]["b"]
    log_std = torch.clamp(
        h @ actor["log_std"]["w"] + actor["log_std"]["b"],
        LOG_STD_MIN, LOG_STD_MAX,
    )
    return mu, log_std


def sample_action_with_noise(actor, obs, noise, action_scale: float):
    """Reparameterized tanh-Gaussian with CALLER-provided unit normals
    ([B, A]): (action [B, A] in [-scale, scale], log-prob [B] with the
    tanh/scale Jacobian folded in). Noise rides the batch so a sharded
    SACLearnerGroup slices per-row noise with the rows — the allreduced
    gradient then equals the full-batch gradient."""
    mu, log_std = actor_dist(actor, obs)
    std = torch.exp(log_std)
    u = mu + std * noise
    a = torch.tanh(u)
    # N(u; mu, std) log-density minus log|d tanh/du| minus log(scale)
    logp = (
        -0.5 * (((u - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))
        - torch.log(1.0 - a ** 2 + 1e-6) - math.log(action_scale)
    ).sum(dim=-1)
    return a * action_scale, logp


def sample_action(actor, obs, gen: torch.Generator, action_scale: float):
    """Generator-driven convenience wrapper over sample_action_with_noise
    (the noise drawn on the generator's device)."""
    mu, _ = actor_dist(actor, obs)
    noise = torch.randn(mu.shape, generator=gen, dtype=torch.float32,
                        device=gen.device).to(mu.device)
    return sample_action_with_noise(actor, obs, noise, action_scale)


def q_value(q, obs, act):
    h = _mlp(q, torch.cat([obs, act], dim=-1))
    return (h @ q["out"]["w"] + q["out"]["b"])[:, 0]


def _detached(tree):
    return tree_map(torch.Tensor.detach, tree)


# ---------------- the update ----------------

class SACLearner:
    """Owns params + target nets + the two Adam states (actor, and critic
    with the temperature) on ``device``. ``grad_fn``/``apply_grads`` form
    the LearnerGroup seam: gradients over the WHOLE params tree computed
    on a shard are allreduced before apply by SACLearnerGroup
    (rl/learner_group.py), whose sharded update equals this single
    learner's because the reparameterization noise rides the batch rows.
    ``seed`` draws the init on the CPU (the same weights on every
    device); ``seed + 1`` seeds the noise generator."""

    def __init__(self, obs_dim: int, action_dim: int, *,
                 action_scale: float = 1.0, lr: float = 3e-4,
                 lr_critic: float | None = None,
                 gamma: float = 0.99, tau: float = 0.005,
                 target_entropy: float | None = None,
                 reward_scale: float = 1.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = init_sac_params(seed, obs_dim, action_dim,
                                      device=self.device)
        self.target = tree_map(
            torch.clone, {"q1": self.params["q1"], "q2": self.params["q2"]})
        self.gamma = gamma
        self.tau = tau
        self.action_scale = action_scale
        self.action_dim = action_dim
        # the original SAC's reward_scale hyperparameter: shrinks the
        # Bellman-target magnitude into a range fresh critics can reach
        self.reward_scale = reward_scale
        self.target_entropy = (
            -float(action_dim) if target_entropy is None else target_entropy
        )
        # separate learning rates (standard SAC practice): critics +
        # temperature track moving Bellman targets and want ~3x the
        # policy's rate
        self.opt = {"actor": adam(lr),
                    "critic": adam(lr_critic if lr_critic else 3 * lr)}
        self.opt_state = {
            "actor": self.opt["actor"].init(self._part(self.params,
                                                       ACTOR_KEYS)),
            "critic": self.opt["critic"].init(self._part(self.params,
                                                         CRITIC_KEYS)),
        }
        self._gen = torch.Generator().manual_seed(seed + 1)

    @staticmethod
    def _part(tree: dict, keys) -> dict:
        return {k: tree[k] for k in keys}

    # -- losses --

    def _loss(self, params, target, batch):
        # reparameterization noise arrives IN the batch ("noise_pi" /
        # "noise_next", [B, A] unit normals): sharded learners slice it
        # with the rows, so the group's row-weighted-mean gradient is the
        # full-batch gradient (with_noise() draws it when the caller
        # didn't)
        obs, act = batch["obs"], batch["actions"]
        alpha = torch.exp(params["log_alpha"])

        # critic: y = r + gamma (1-d) [min Q_tgt(s', a') - alpha logp(a')]
        a_next, logp_next = sample_action_with_noise(
            params["actor"], batch["next_obs"], batch["noise_next"],
            self.action_scale
        )
        q_next = torch.minimum(
            q_value(target["q1"], batch["next_obs"], a_next),
            q_value(target["q2"], batch["next_obs"], a_next),
        )
        y = batch["rewards"] * self.reward_scale + self.gamma * (
            1.0 - batch["dones"].to(torch.float32)
        ) * (q_next - alpha * logp_next).detach()
        q1 = q_value(params["q1"], obs, act)
        q2 = q_value(params["q2"], obs, act)
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)

        # actor: alpha logp - min Q, through the reparameterized sample;
        # stop-grad the critics so the actor term cannot train them
        a_pi, logp_pi = sample_action_with_noise(
            params["actor"], obs, batch["noise_pi"], self.action_scale
        )
        q_pi = torch.minimum(
            q_value(_detached(params["q1"]), obs, a_pi),
            q_value(_detached(params["q2"]), obs, a_pi),
        )
        actor_loss = torch.mean(alpha.detach() * logp_pi - q_pi)

        # temperature: alpha tracks the entropy target
        alpha_loss = -torch.mean(
            params["log_alpha"] * (logp_pi + self.target_entropy).detach()
        )

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha": alpha,
            "entropy": -torch.mean(logp_pi),
        }

    def _grad_fn(self, params, target, batch):
        (_, metrics), grads = value_and_grad(self._loss, params, target,
                                             batch)
        return grads, metrics

    @torch.no_grad()
    def _apply_fn(self, params, target, opt_state, grads):
        updates, new_state = {}, {}
        for label, keys in (("actor", ACTOR_KEYS), ("critic", CRITIC_KEYS)):
            u, new_state[label] = self.opt[label].update(
                self._part(grads, keys), opt_state[label],
                self._part(params, keys))
            updates.update(u)
        params = apply_updates(params, updates)
        target = tree_map(
            lambda t, p: (1.0 - self.tau) * t + self.tau * p,
            target, {"q1": params["q1"], "q2": params["q2"]},
        )
        return params, target, new_state

    # -- public seam --

    def with_noise(self, batch: dict, gen: torch.Generator | None = None
                   ) -> dict:
        """Return a copy of `batch` carrying reparameterization noise
        (no-op if already present), drawn from ``gen`` (None: the
        learner's own generator). The group path draws it ONCE on the
        full batch before sharding."""
        if "noise_pi" in batch:
            return batch
        gen = self._gen if gen is None else gen
        b = len(batch["obs"])
        out = dict(batch)
        out["noise_pi"] = torch.randn((b, self.action_dim), generator=gen
                                      ).numpy()
        out["noise_next"] = torch.randn((b, self.action_dim), generator=gen
                                        ).numpy()
        return out

    def grad_fn(self, batch: dict, gen: torch.Generator | None = None
                ) -> tuple:
        """(grads, metrics) of one batch of numpy columns."""
        return self._grad_fn(self.params, self.target, batch_to(
            self.with_noise(batch, gen), _BATCH_KEYS, self.device))

    def apply_grads(self, grads):
        self.params, self.target, self.opt_state = self._apply_fn(
            self.params, self.target, self.opt_state, grads
        )

    def update(self, batch: dict, *, grad_hook=None) -> dict:
        """One gradient step; grad_hook(grads, n_rows) -> grads is the
        allreduce seam between gradient and apply."""
        grads, metrics = self.grad_fn(batch)
        if grad_hook is not None:
            grads = grad_hook(grads, len(batch["obs"]))
        self.apply_grads(grads)
        return metrics

    @torch.no_grad()
    def act(self, obs: np.ndarray, gen: torch.Generator | None = None,
            deterministic: bool = False) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        if deterministic:
            mu, _ = actor_dist(self.params["actor"], x)
            return torch.tanh(mu) * self.action_scale
        a, _ = sample_action(self.params["actor"], x,
                             self._gen if gen is None else gen,
                             self.action_scale)
        return a

    def get_weights(self):
        """The params as CPU tensors."""
        return models.to_host(self.params)


# ---------------- sampling member ----------------

class GaussianEnvRunner:
    """Continuous-control sampler: squashed-Gaussian policy on the CPU
    (the algorithm passes ``RUNNER_DEVICE``, as JAX pins it), obs/action
    connector pipelines applied around it. The policy's noise comes from
    a ``torch.Generator`` seeded with ``seed``; the uniform warm-up from
    numpy ``RandomState(seed)``, as in JAX."""

    def __init__(self, env_creator, action_scale: float, connectors=None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = env_creator()
        self.action_scale = action_scale
        self._gen = torch.Generator().manual_seed(seed)
        self.rng = np.random.RandomState(seed)  # warmup exploration
        self.obs_pipe = _conn.pipeline_from_blob(connectors)
        self.act_pipe = _conn.ClipAction(-action_scale, action_scale)
        self.returns = EpisodeReturns(1)
        self._obs = self.obs_pipe(np.asarray(self.env.reset(), np.float32))
        self.actor = None

    def set_weights(self, actor_params):
        self.actor = models.as_tensors(actor_params, self.device)
        return True

    def connector_state(self) -> dict:
        return self.obs_pipe.state_dict()

    @torch.no_grad()
    def _policy(self, obs: np.ndarray) -> np.ndarray:
        a, _ = sample_action(self.actor,
                             torch.from_numpy(obs[None]).to(self.device),
                             self._gen, self.action_scale)
        return a[0].cpu().numpy().astype(np.float32)

    def sample(self, n_steps: int, random_until: int = 0,
               total_steps: int = 0) -> dict:
        obs_l, act_l, rew_l, done_l, next_l = [], [], [], [], []
        obs = self._obs
        for i in range(n_steps):
            if total_steps + i < random_until:
                a = self.rng.uniform(
                    -self.action_scale, self.action_scale,
                    size=(self.env.action_dim,),
                ).astype(np.float32)
            else:
                a = self._policy(obs)
            a = self.act_pipe(a)
            nxt, r, done, info = self.env.step(a)
            nxt = self.obs_pipe(np.asarray(nxt, np.float32))
            self.returns.step(0, float(r), bool(done))
            obs_l.append(obs)
            act_l.append(a)
            rew_l.append(float(r))
            # bootstrap THROUGH time-limit truncations: only a true
            # terminal zeroes the Bellman bootstrap (gymnasium's
            # terminated/truncated distinction; rllib does the same)
            done_l.append(bool(done) and not info.get("truncated", False))
            next_l.append(nxt)
            if done:
                self.obs_pipe.reset()
                obs = self.obs_pipe(
                    np.asarray(self.env.reset(), np.float32)
                )
            else:
                obs = nxt
        self._obs = obs
        return {
            "obs": np.stack(obs_l),
            "actions": np.stack(act_l),
            "rewards": np.asarray(rew_l, np.float32),
            "dones": np.asarray(done_l, np.bool_),
            "next_obs": np.stack(next_l),
            "episode_return_mean": self.returns.mean(),
        }


# ---------------- the algorithm ----------------

@dataclass
class SACConfig:
    env_creator: Callable | None = None
    obs_dim: int = 3
    action_dim: int = 1
    action_scale: float = 1.0
    num_env_runners: int = 1
    rollout_steps: int = 256
    buffer_capacity: int = 100_000
    learning_starts: int = 512
    random_steps: int = 512          # uniform exploration warmup
    train_batch_size: int = 128
    grad_steps_per_iteration: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    reward_scale: float = 1.0
    target_entropy: float | None = None
    # env_to_module connector pipeline factory (rllib/connectors analog);
    # None = identity. e.g. lambda: Pipeline(ObsNormalizer())
    connectors: Callable | None = None
    seed: int = 0

    def build(self, *, runtime=None, device=None) -> "SAC":
        return SAC(self, runtime=runtime, device=device)


class SAC:
    """The SAC loop: the runners come through ``runtime`` (None:
    in-process), each on the CPU; the learner runs on ``device``."""

    def __init__(self, config: SACConfig, *, runtime=None, device=None):
        assert config.env_creator is not None, "set SACConfig.env_creator"
        self.config = config
        self.runtime = runtime or InProcessRuntime()
        self.learner = SACLearner(
            config.obs_dim, config.action_dim,
            action_scale=config.action_scale, lr=config.lr,
            gamma=config.gamma, tau=config.tau,
            target_entropy=config.target_entropy,
            reward_scale=config.reward_scale, seed=config.seed,
            device=device,
        )
        self.buffer = ReplayBuffer(
            config.buffer_capacity, config.obs_dim, seed=config.seed,
            action_dim=config.action_dim,
        )
        self.runners = [
            self.runtime.spawn(GaussianEnvRunner, dict(
                env_creator=config.env_creator,
                action_scale=config.action_scale,
                connectors=config.connectors, seed=config.seed + i,
                device=RUNNER_DEVICE), name=f"gaussian-env-runner-{i}")
            for i in range(config.num_env_runners)
        ]
        self.total_steps = 0
        self.iteration = 0
        self._sync_weights()

    def _sync_weights(self):
        rt = self.runtime
        actor = models.to_host(self.learner.params["actor"])
        rt.get([rt.call(r, "set_weights", actor) for r in self.runners],
               timeout=120)

    def train(self) -> dict:
        c = self.config
        rt = self.runtime
        batches = rt.get(
            [rt.call(r, "sample", c.rollout_steps, c.random_steps,
                     self.total_steps)
             for r in self.runners],
            timeout=600,
        )
        for b in batches:
            self.buffer.add_batch(
                b["obs"], b["actions"], b["rewards"], b["dones"],
                b["next_obs"],
            )
            self.total_steps += len(b["rewards"])
        metrics = {}
        if len(self.buffer) >= c.learning_starts:
            for _ in range(c.grad_steps_per_iteration):
                metrics = self.learner.update(
                    self.buffer.sample(c.train_batch_size))
            metrics = {k: float(v) for k, v in metrics.items()}
        self._sync_weights()
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "total_steps": self.total_steps,
            "buffer_size": len(self.buffer),
            "episode_return_mean": float(np.mean(
                [b["episode_return_mean"] for b in batches]
            )),
            **metrics,
        }

    def stop(self):
        for r in self.runners:
            try:
                self.runtime.kill(r)
            except Exception:  # noqa: BLE001
                pass
