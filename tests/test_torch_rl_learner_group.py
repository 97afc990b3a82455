"""The port's learner groups against the single learners, the port's and
JAX's, on the CPU through the in-process runtime.

- ``LearnerGroup(2)`` against the port's ``Learner`` and JAX's, from
  JAX's weights, on one 64-row batch (minibatches=1, epochs=3) and on an
  unequal 33/32 split of 65 rows (epochs=2): params at rtol 1e-4, atol
  1e-5 (JAX's own tolerances, tests/test_rl_learner_group.py:54); the two
  replicas bit-equal after a sharded multi-minibatch update;
- ``SACLearnerGroup(2)`` against ``SACLearner``, the port's and JAX's,
  over 3 updates with given noise, even and unequal shards: rtol 1e-4,
  atol 1e-5 (tests/test_rl_sac.py:237), against JAX's under the Adam
  rule (_assert_adam_close: that tolerance above f32's gradient noise
  floor, the steps' bound below it);
- the shard guard raising on a batch of 1; the runtime's collective
  summing over the ring and raising CollectiveTimeoutError past its
  deadline;
- PPO with num_learners=2 in process against PPO with one learner, from
  the same seeds, for 2 iterations.

The members are threads that run torch's CPU kernels at once; the
comparisons here hold at 1e-4, and the replicas' bit-equality needs only
that both apply one allreduced gradient to equal params.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import learner as j_learner
from ray_tpu.rl import sac as j_sac
from ray_tpu_torch.rl import learner as t_learner
from ray_tpu_torch.rl import learner_group as t_lg
from ray_tpu_torch.rl import ppo as t_ppo
from ray_tpu_torch.rl import sac as t_sac
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.train.worker_group import CollectiveTimeoutError
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths
from tests.test_rl import Corridor
from tests.test_torch_rl import _carry, _np

GROUP_TOL = dict(rtol=1e-4, atol=1e-5)  # JAX's tests' tolerances


def _fake_batch(n, obs_dim=4, n_actions=2, seed=0):
    """tests/test_rl_learner_group.py's batch."""
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.randn(n, obs_dim).astype(np.float32),
        "actions": rng.randint(0, n_actions, n).astype(np.int32),
        "logp": (-np.abs(rng.randn(n))).astype(np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "returns": rng.randn(n).astype(np.float32),
    }


def _assert_flat_close(got, want, **tol):
    """Leaf for leaf, by sorted-key order (torch or numpy/JAX leaves)."""
    want = _np(want)
    assert tree_paths(got) == tree_paths(want)
    for path, g, w in zip(tree_paths(got), tree_leaves(got),
                          tree_leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, w, err_msg=path, **tol)


def _assert_adam_close(got, want, grads, lr_of):
    """``got`` against JAX's ``want`` after len(grads) Adam steps, JAX's
    gradient at each step given: GROUP_TOL wherever every step's gradient
    stands above f32's noise floor (|g| > 1e-4 x the leaf's largest) or is
    0 at every step. Below the floor Adam's g / (|g| + eps) follows the
    noise's sign, so there an element may miss GROUP_TOL, held instead to
    the steps' bound, |delta| <= 2 lr a step, on at most 2% of a leaf
    (tests/test_torch_rl.py's assert_adam_step_close over several
    steps)."""
    want = _np(want)
    held = {}
    for g in grads:
        for path, w in zip(tree_paths(g), tree_leaves(g)):
            scale = float(np.abs(w).max()) or 1.0
            live, still = held.get(path, (True, True))
            held[path] = (live & (np.abs(w) > 1e-4 * scale), still & (w == 0))
    assert tree_paths(got) == tree_paths(want)
    for path, g, w in zip(tree_paths(got), tree_leaves(got),
                          tree_leaves(want)):
        g = g.numpy()
        live, still = held[path]
        m = np.broadcast_to(live | still, w.shape)
        np.testing.assert_allclose(g[m], w[m], err_msg=path, **GROUP_TOL)
        assert np.all(np.abs(g - w) <= 2 * lr_of(path) * len(grads)), path
        missed = ~np.isclose(g, w, **GROUP_TOL)
        assert missed.mean() <= 0.02, (path, int(missed.sum()))


def _member_weights(group):
    rt = group.runtime
    return rt.get([rt.call(a, "get_weights") for a in group.learners])


@pytest.mark.parametrize("n,epochs", [(64, 3), (65, 2)],
                         ids=["even", "unequal"])
def test_learner_group_matches_single_learners(n, epochs):
    """Two learners, each on its array_split shard, row-weighted mean
    allreduced gradients: params equal to the single learner's full-batch
    update (minibatches=1, so minibatch membership is identical), the
    port's and JAX's, from JAX's init."""
    batch = _fake_batch(n, seed=0 if n == 64 else 5)
    jax_solo = j_learner.Learner(4, 2, seed=0)
    w0 = jax_solo.get_weights()
    jax_solo.update(dict(batch), minibatches=1, epochs=epochs)
    solo = t_learner.Learner(4, 2, device="cpu")
    solo.params = _carry(w0)
    solo.opt_state = solo.opt.init(solo.params)
    solo.update(dict(batch), minibatches=1, epochs=epochs)
    group = t_lg.LearnerGroup(4, 2, num_learners=2, seed=0, device="cpu")
    try:
        group.set_weights(_np(w0))
        m = group.update(dict(batch), minibatches=1, epochs=epochs)
        assert set(m) == {"policy_loss", "vf_loss", "entropy", "total_loss"}
        got = group.get_weights()
        _assert_flat_close(got, solo.get_weights(), **GROUP_TOL)
        _assert_flat_close(got, jax_solo.get_weights(), **GROUP_TOL)
        a, b = _member_weights(group)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    finally:
        group.shutdown()


def test_learner_group_replicas_stay_identical():
    """After sharded multi-minibatch updates (96 rows, 3 minibatches, 2
    epochs) every replica holds bit-equal params: the allreduce is the
    only thing keeping them in sync."""
    group = t_lg.LearnerGroup(4, 2, num_learners=2, seed=0, device="cpu")
    try:
        before = group.get_weights()
        group.update(_fake_batch(96, seed=1), minibatches=3, epochs=2)
        a, b = _member_weights(group)
        for x, y, z in zip(tree_leaves(a), tree_leaves(b),
                           tree_leaves(before)):
            assert torch.equal(x, y)
        assert any(not torch.equal(x, z) for x, z in zip(
            tree_leaves(a), tree_leaves(before)))
    finally:
        group.shutdown()


@pytest.mark.parametrize("kind", ["ppo", "sac"])
def test_shard_guard_raises_on_a_batch_too_small(kind):
    if kind == "ppo":
        group = t_lg.LearnerGroup(4, 2, num_learners=2, device="cpu")
        batch = _fake_batch(1)
    else:
        group = t_lg.SACLearnerGroup(3, 1, num_learners=2, device="cpu")
        batch = _sac_batch(1, seed=0)
    try:
        with pytest.raises(ValueError, match="cannot shard across 2"):
            group.update(batch)
    finally:
        group.shutdown()


def _sac_batch(n, seed, obs_dim=3, action_dim=1):
    """tests/test_rl_sac.py's group-parity batch, noise from numpy."""
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.randn(n, obs_dim).astype(np.float32),
        "actions": np.tanh(rng.randn(n, action_dim)).astype(np.float32),
        "rewards": rng.randn(n).astype(np.float32),
        "next_obs": rng.randn(n, obs_dim).astype(np.float32),
        "dones": (rng.rand(n) < 0.1),
        "noise_pi": rng.randn(n, action_dim).astype(np.float32),
        "noise_next": rng.randn(n, action_dim).astype(np.float32),
    }


def _set_sac_weights(learner, params):
    learner.params = _carry(params)
    learner.target = _carry({"q1": params["q1"], "q2": params["q2"]})


@pytest.mark.parametrize("n", [64, 65], ids=["even", "unequal"])
def test_sac_learner_group_matches_single_learners(n):
    """3 updates of SACLearnerGroup(2) against SACLearner, the port's and
    JAX's, from JAX's weights (seed 7), with given noise."""
    batch = _sac_batch(n, seed=0)
    jax_solo = j_sac.SACLearner(3, 1, seed=7)
    w0 = jax_solo.get_weights()
    solo = t_sac.SACLearner(3, 1, seed=7, device="cpu")
    _set_sac_weights(solo, w0)
    group = t_lg.SACLearnerGroup(3, 1, num_learners=2, seed=7, device="cpu")
    try:
        for member in group.learners:  # in-process members: the objects
            _set_sac_weights(member.obj.learner, w0)
        j_grads = []
        for _ in range(3):
            jax_solo.update({k: jnp.asarray(v) for k, v in batch.items()},
                            grad_hook=lambda g, n: j_grads.append(_np(g)) or g)
            solo.update(dict(batch))
            m = group.update(dict(batch))
        assert set(m) == {"critic_loss", "actor_loss", "alpha", "entropy"}
        got = group.get_weights()
        _assert_flat_close(got, solo.get_weights(), **GROUP_TOL)
        _assert_adam_close(got, jax.device_get(jax_solo.get_weights()),
                           j_grads, lambda p: 3e-4 if p.startswith("actor")
                           else 9e-4)
        a, b = _member_weights(group)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
        obs = batch["obs"][:4]
        acts = group.runtime.get(group.runtime.call(
            group.learners[1], "act_deterministic", obs))
        np.testing.assert_allclose(
            acts, solo.act(obs, deterministic=True).numpy(), **GROUP_TOL)
    finally:
        group.shutdown()


def test_sac_learner_group_draws_the_single_learners_noise():
    """Without given noise the group draws it once on the driver from a
    generator seeded seed + 1, as a single SACLearner does, so the two
    make the same 2 updates."""
    batch = {k: v for k, v in _sac_batch(32, seed=3).items()
             if not k.startswith("noise")}
    solo = t_sac.SACLearner(3, 1, seed=2, device="cpu")
    group = t_lg.SACLearnerGroup(3, 1, num_learners=2, seed=2, device="cpu")
    try:
        for _ in range(2):
            solo.update(dict(batch))
            group.update(dict(batch))
        _assert_flat_close(group.get_weights(), solo.get_weights(),
                           **GROUP_TOL)
    finally:
        group.shutdown()


def test_in_process_collective_sums_in_rank_order_and_times_out():
    """The runtime's collective: each rank's callable returns the sum of
    every rank's f32 vector as a fresh array, each segment folded in the
    ring's order (a rotation of rank order: segment s is
    v_s + (v_{s-1} + v_{s-2}) at world 3, as JAX's ring folds it); a
    rank whose peers never arrive raises CollectiveTimeoutError."""
    rt = InProcessRuntime()

    class Member:
        pass

    handles = [rt.spawn(Member, {}) for _ in range(3)]
    fns = rt.collective(handles, "g")
    vecs = [np.float32([1e8, 1e8, 2.0]), np.float32([1.0, 1.0, 0.5]),
            np.float32([-1e8, -1e8, 0.25])]
    out = [None] * 3

    def run(r):
        out[r] = fns[r](vecs[r])

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    want = np.float32([vecs[s][s] + (vecs[s - 1][s] + vecs[s - 2][s])
                       for s in range(3)])
    assert want[1] == 1.0  # in rank order, 1e8 + 1 rounds to 1e8 first: 0
    for o in out:
        np.testing.assert_array_equal(o, want)
    assert out[0] is not out[1]
    lone = rt.collective(handles[:2], "h")[0]
    t0 = time.monotonic()
    with pytest.raises(CollectiveTimeoutError):
        lone(np.zeros(2, np.float32), timeout=0.3)
    assert time.monotonic() - t0 < 10


class _OneSpawnFails(InProcessRuntime):
    """Refuses to build the member named ``refused``; records the members
    built and killed."""

    def __init__(self, refused: str):
        super().__init__()
        self.refused = refused
        self.built, self.killed = [], []

    def spawn(self, cls, kwargs, *, name="", max_concurrency=1):
        if name == self.refused:
            raise RuntimeError(f"no room for {name}")
        handle = super().spawn(cls, kwargs, name=name,
                               max_concurrency=max_concurrency)
        self.built.append(handle)
        return handle

    def kill(self, handle):
        self.killed.append(handle)
        super().kill(handle)


@pytest.mark.parametrize("kind", ["ppo", "sac"])
def test_a_failed_learner_spawn_kills_the_learners_built(kind):
    """The group spawns its members at once (``serve.runtime
    .spawn_at_once``): one refused spawn raises its error, and every
    member built is killed, none left running."""
    cls = t_lg.LearnerActor if kind == "ppo" else t_lg.SACLearnerActor
    rt = _OneSpawnFails(f"{cls.__name__}-1")
    with pytest.raises(RuntimeError, match=f"no room for {cls.__name__}-1"):
        if kind == "ppo":
            t_lg.LearnerGroup(4, 2, num_learners=3, device="cpu", runtime=rt)
        else:
            t_lg.SACLearnerGroup(3, 1, num_learners=3, device="cpu",
                                 runtime=rt)
    assert sorted(h.name for h in rt.built) == [f"{cls.__name__}-0",
                                                f"{cls.__name__}-2"]
    assert {id(h) for h in rt.killed} == {id(h) for h in rt.built}
    assert all(h.dead for h in rt.built)


def test_ppo_with_two_learners_matches_one():
    """PPO with num_learners=2 (a LearnerGroup through the in-process
    runtime) against PPO with one learner, from the same seeds: the same
    sampled returns and, after each of 2 iterations, the params at rtol
    1e-4, atol 1e-5; stop() ends the group's members. One minibatch an
    epoch: each member shuffles its own shard, so past one minibatch the
    group's minibatches hold other rows than the single learner's (as in
    JAX)."""
    cfg = dict(env_creator=Corridor, obs_dim=2, n_actions=2,
               num_env_runners=2, rollout_steps=32, lr=5e-3,
               entropy_coeff=0.0, sgd_minibatches=1, sgd_epochs=3)
    one = t_ppo.PPOConfig(**cfg).build(device="cpu")
    two = t_ppo.PPOConfig(**cfg, num_learners=2).build(device="cpu")
    try:
        assert isinstance(two.learner, t_lg.LearnerGroup)
        assert two.learner.runtime is two.runtime
        for it in range(2):
            m1, m2 = one.train(), two.train()
            assert m2["training_iteration"] == it + 1
            assert m1["episode_return_mean"] == m2["episode_return_mean"]
            assert all(np.isfinite(v) for v in m2.values())
            _assert_flat_close(two.learner.get_weights(),
                               one.learner.get_weights(), **GROUP_TOL)
    finally:
        one.stop()
        two.stop()
    assert all(a.dead for a in two.learner.learners)
