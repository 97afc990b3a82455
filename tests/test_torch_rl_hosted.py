"""The ray_tpu runtime hosts the port's PPO over its own actors.

The port's algorithms take their calls on members from a runtime value
(``serve.runtime``'s interface); here it is built from ``ray_tpu.remote``,
``get``, ``wait``, ``put`` and ``kill``, so each env runner is the port's
``EnvRunner`` as a ray_tpu actor on the CPU. The port's PPO and JAX's
run side by side on one cluster, from the same weights (JAX's learner
init, carried across) and the same runner seeds, for 2 iterations: each
iteration's sampled batch (actions equal, logp at rtol 1e-5) and the
learner's params after each update (rtol 1e-4, atol 1e-6: 8 Adam steps
an iteration in f32 on each side) agree.
"""

import sys

import cloudpickle
import jax
import numpy as np
import pytest

import ray_tpu
from ray_tpu.cluster_utils import Cluster
from ray_tpu.rl import ppo as j_ppo
from ray_tpu_torch.rl import models as t_models
from ray_tpu_torch.rl import ppo as t_ppo
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths

ITERATIONS = 2


class RayRuntime:
    """``serve.runtime``'s interface over ray_tpu actors."""

    actor_error = ray_tpu.RayActorError

    def spawn(self, cls, kwargs, *, name="", max_concurrency=1):
        return ray_tpu.remote(num_cpus=0)(cls).options(
            max_concurrency=max_concurrency).remote(**kwargs)

    def call(self, handle, method, *args, fetch_tags=None, **kwargs):
        return getattr(handle, method).remote(*args, **kwargs)

    def get(self, refs, timeout=None):
        return ray_tpu.get(refs, timeout=timeout)

    def wait(self, refs, num_returns=1, timeout=None):
        return ray_tpu.wait(list(refs), num_returns=num_returns,
                            timeout=timeout)

    def put(self, tree):
        return ray_tpu.put(tree)

    def is_ref(self, x):
        return isinstance(x, ray_tpu.ObjectRef)

    def kill(self, handle):
        ray_tpu.kill(handle)

    def is_initialized(self):
        return ray_tpu.is_initialized()


class Corridor:
    """tests/test_rl.py's corridor: 5 steps right to the goal (+1), -0.05
    a step, obs [pos / 5, 1]."""

    N = 5

    def __init__(self):
        self.pos = 0

    def reset(self):
        self.pos = 0
        return self._obs()

    def _obs(self):
        return np.array([self.pos / self.N, 1.0], np.float32)

    def step(self, action):
        self.pos = max(0, self.pos + (1 if action == 1 else -1))
        done = self.pos >= self.N
        return self._obs(), (1.0 if done else -0.05), done, {}


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"CPU": 4, "memory": 2 * 2**30})
    c.connect()
    yield c
    c.shutdown()


def _recording(update, into):
    """A learner's update that keeps each batch it was given."""
    def run(batch, **kw):
        into.append({k: np.array(v) for k, v in batch.items()})
        return update(batch, **kw)
    return run


def test_hosted_ppo_matches_jax(cluster):
    cfg = dict(env_creator=Corridor, obs_dim=2, n_actions=2,
               num_env_runners=2, rollout_steps=64, lr=5e-3,
               entropy_coeff=0.0, sgd_minibatches=4, sgd_epochs=2)
    j = j_ppo.PPO(j_ppo.PPOConfig(**cfg))
    t = None
    try:
        # JAX's build ships the env by value and then drops this module's
        # by-value registration: the port's runners need it back
        cloudpickle.register_pickle_by_value(sys.modules[__name__])
        t = t_ppo.PPO(t_ppo.PPOConfig(**cfg), runtime=RayRuntime(),
                      device="cpu")
        t.learner.params = t_models.from_jax_params(
            j.learner.get_weights(), device="cpu")
        t.learner.opt_state = t.learner.opt.init(t.learner.params)
        t._sync_weights()
        seen_j, seen_t = [], []
        j.learner.update = _recording(j.learner.update, seen_j)
        t.learner.update = _recording(t.learner.update, seen_t)
        for it in range(ITERATIONS):
            mj, mt = j.train(), t.train()
            bj, bt = seen_j[it], seen_t[it]
            np.testing.assert_array_equal(bt["actions"], bj["actions"])
            np.testing.assert_array_equal(bt["obs"], bj["obs"])
            np.testing.assert_allclose(bt["logp"], bj["logp"], rtol=1e-5)
            np.testing.assert_allclose(bt["returns"], bj["returns"],
                                       rtol=1e-4, atol=1e-6)
            assert mt["episode_return_mean"] == mj["episode_return_mean"]
            assert mt["training_iteration"] == it + 1
            want = j.learner.get_weights()
            got = t.learner.get_weights()
            assert tree_paths(got) == tree_paths(
                jax.tree_util.tree_map(np.asarray, want))
            for path, g, w in zip(tree_paths(got), tree_leaves(got),
                                  tree_leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"iteration {it} {path}")
    finally:
        j.stop()
        if t is not None:
            t.stop()
