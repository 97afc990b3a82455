"""The port's RL layer against ray_tpu.rl on the CPU.

The same seeded numpy inputs (and, where a module holds weights, JAX's
weights carried across with ``models.from_jax_params``) go through the
JAX function and its port counterpart: V-trace, GAE and advantage
normalization, the policy nets and the three modules, one PPO learner
update, the IMPALA, APPO and BC updates, both env runners' sampling, the
connectors and the multi-agent wrapper. Tolerances (f32 on both sides)
are stated at each comparison. JAX's algorithms are driven without a
cluster: the update functions through their own classes' seams, the
runners through the plain classes under their actor wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu._private import serialization
from ray_tpu.rl import appo as j_appo
from ray_tpu.rl import bc as j_bc
from ray_tpu.rl import connectors as j_conn
from ray_tpu.rl import env_runner as j_env_runner
from ray_tpu.rl import impala as j_impala
from ray_tpu.rl import learner as j_learner
from ray_tpu.rl import models as j_models
from ray_tpu.rl import multi_agent as j_ma
from ray_tpu.rl import rl_module as j_rlm
from ray_tpu.rl import vector_env as j_vector_env
from ray_tpu.rl.vtrace import vtrace as j_vtrace
from ray_tpu_torch.rl import appo as t_appo
from ray_tpu_torch.rl import bc as t_bc
from ray_tpu_torch.rl import connectors as t_conn
from ray_tpu_torch.rl import env_runner as t_env_runner
from ray_tpu_torch.rl import impala as t_impala
from ray_tpu_torch.rl import learner as t_learner
from ray_tpu_torch.rl import models as t_models
from ray_tpu_torch.rl import multi_agent as t_ma
from ray_tpu_torch.rl import ppo as t_ppo
from ray_tpu_torch.rl import rl_module as t_rlm
from ray_tpu_torch.rl import vector_env as t_vector_env
from ray_tpu_torch.rl.vtrace import vtrace as t_vtrace
from ray_tpu_torch.utils import prng
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths
from tests.test_rl import Corridor

F32 = dict(rtol=1e-5, atol=1e-6)  # forwards and one-step updates, f32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jtree):
    return t_models.from_jax_params(_np(jtree), device="cpu")


def assert_trees_close(got, want, **tol):
    """Leaf for leaf, by JAX's sorted-key order: a port tree of tensors
    against a JAX (or numpy) tree of the same keys."""
    want = _np(want)
    assert tree_paths(got) == tree_paths(want)
    for path, g, w in zip(tree_paths(got), tree_leaves(got),
                          tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=path, **tol)


# ---------------- V-trace, GAE ----------------


def _vtrace_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    mu = -np.abs(rng.randn(*shape)).astype(np.float32)
    # ratios well past rho_bar / c_bar on some steps, well below on others
    pi = (mu + rng.randn(*shape) * 1.5).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    boot = np.asarray(rng.randn(*shape[1:]), np.float32)
    dones = rng.rand(*shape) < 0.2
    return mu, pi, r, v, boot, dones


@pytest.mark.parametrize("shape", [(17,), (12, 5)], ids=["T", "TxB"])
@pytest.mark.parametrize("hp", [
    dict(gamma=0.99, lam=1.0, rho_bar=1.0, c_bar=1.0),
    dict(gamma=0.95, lam=0.9, rho_bar=0.8, c_bar=1.2),
], ids=["defaults", "lam_clip"])
def test_vtrace_matches_jax(shape, hp):
    args = _vtrace_inputs(shape, seed=len(shape))
    want_vs, want_adv = j_vtrace(*args, **hp)
    got_vs, got_adv = t_vtrace(*(torch.from_numpy(np.asarray(a))
                                 for a in args), **hp)
    assert got_vs.shape == shape and not got_vs.requires_grad
    # rtol 1e-6 (atol 1e-6 for the entries near 0): one f32 recursion
    np.testing.assert_allclose(got_vs.numpy(), np.asarray(want_vs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_adv.numpy(), np.asarray(want_adv),
                               rtol=1e-6, atol=1e-6)


def test_vtrace_stops_gradients():
    mu, pi, r, v, boot, dones = _vtrace_inputs((6,), seed=3)
    pi_t = torch.from_numpy(pi).requires_grad_()
    vs, adv = t_vtrace(mu, pi_t, r, v, boot, dones)
    assert not vs.requires_grad and not adv.requires_grad


def test_gae_and_normalize_match_jax():
    rng = np.random.RandomState(4)
    rewards = rng.randn(40).astype(np.float32)
    values = rng.randn(40).astype(np.float32)
    dones = rng.rand(40) < 0.15
    for gamma, lam in ((0.99, 0.95), (1.0, 1.0)):
        want = j_learner.compute_gae(rewards, values, dones, 0.3,
                                     gamma=gamma, lam=lam)
        got = t_learner.compute_gae(rewards, values, dones, 0.3,
                                    gamma=gamma, lam=lam)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    batch = {"advantages": rng.randn(33).astype(np.float32), "x": 1}
    np.testing.assert_allclose(
        t_learner.normalize_advantages(batch)["advantages"],
        j_learner.normalize_advantages(batch)["advantages"], rtol=1e-6)


# ---------------- policy nets and modules ----------------


def test_policy_forward_matches_jax():
    jp = j_models.init_policy(jax.random.PRNGKey(1), 6, 3, hidden=32)
    obs = np.random.RandomState(1).randn(9, 6).astype(np.float32)
    want_logits, want_v = j_models.forward(jp, jnp.asarray(obs))
    got_logits, got_v = t_models.forward(_carry(jp), torch.from_numpy(obs))
    np.testing.assert_allclose(got_logits.numpy(), want_logits, **F32)
    np.testing.assert_allclose(got_v.numpy(), want_v, **F32)


def test_port_init_law_and_tree():
    """The port's init keeps JAX's keys and shapes, and one seed gives one
    tree on every device (drawn on the CPU)."""
    jp = j_models.init_policy(jax.random.PRNGKey(0), 5, 4, hidden=16)
    tp = t_models.init_policy(0, 5, 4, hidden=16, device="cpu")
    assert tree_paths(tp) == tree_paths(_np(jp))
    assert [tuple(x.shape) for x in tree_leaves(tp)] == [
        x.shape for x in tree_leaves(_np(jp))]
    again = t_models.init_policy(0, 5, 4, hidden=16, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))
    vis = t_rlm.VisionPolicyModule((7, 9, 3), 4)
    jvis = j_rlm.VisionPolicyModule((7, 9, 3), 4)
    assert [tuple(x.shape) for x in tree_leaves(vis.init(0, device="cpu"))] \
        == [x.shape for x in tree_leaves(_np(jvis.init(
            jax.random.PRNGKey(0))))]


MODULES = {
    "discrete": (lambda m: m.DiscretePolicyModule(6, 3, hidden=32), (6,)),
    # 8x8: SAME at stride 2 pads one row/column at the end only
    "vision_even": (lambda m: m.VisionPolicyModule((8, 8, 3), 4,
                                                   channels=(4, 8),
                                                   hidden=16), (8, 8, 3)),
    # 7x9: odd sizes pad one row/column on each side
    "vision_odd": (lambda m: m.VisionPolicyModule((7, 9, 2), 5,
                                                  channels=(4, 6),
                                                  hidden=16), (7, 9, 2)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_forward_train_matches_jax(name):
    make, obs_shape = MODULES[name]
    jm, tm = make(j_rlm), make(t_rlm)
    jp = jm.init(jax.random.PRNGKey(2))
    tp = _carry(jp)
    obs = np.random.RandomState(2).randn(5, *obs_shape).astype(np.float32)
    want = jm.forward_train(jp, jnp.asarray(obs))
    got = tm.forward_train(tp, torch.from_numpy(obs))
    for k in ("logits", "vf"):
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **F32)
    if name.startswith("vision"):  # flattened rows ride a [B, D] batch
        flat = tm.forward_train(tp, torch.from_numpy(obs.reshape(5, -1)))
        np.testing.assert_allclose(flat["logits"].numpy(), want["logits"],
                                   **F32)
    np.testing.assert_array_equal(
        tm.forward_inference(tp, torch.from_numpy(obs)).numpy(),
        np.asarray(jm.forward_inference(jp, jnp.asarray(obs))))
    # exploration: the port samples with its own threefry; the log-probs
    # of the actions it drew are JAX's log-probs of those actions
    act, logp = tm.forward_exploration(tp, torch.from_numpy(obs),
                                       prng.prng_key(7))
    want_logp = jax.nn.log_softmax(want["logits"])[np.arange(5),
                                                   act.numpy()]
    np.testing.assert_allclose(logp.numpy(), want_logp, **F32)


# ---------------- learners ----------------


def _ppo_batch(n, obs_dim, n_actions, seed):
    rng = np.random.RandomState(seed)
    return {"obs": rng.randn(n, obs_dim).astype(np.float32),
            "actions": rng.randint(0, n_actions, n).astype(np.int32),
            "logp": -rng.rand(n).astype(np.float32) * 1.5,
            "advantages": rng.randn(n).astype(np.float32),
            "returns": rng.randn(n).astype(np.float32)}


def test_learner_update_matches_jax():
    """2 epochs x 4 minibatches from the same weights and batch: params
    and both Adam moments at rtol 1e-5, atol 1e-7; metrics at rtol 1e-5."""
    j = j_learner.Learner(5, 3, lr=3e-3, seed=3)
    t = t_learner.Learner(5, 3, lr=3e-3, device="cpu")
    t.params = _carry(j.params)
    t.opt_state = t.opt.init(t.params)
    batch = _ppo_batch(64, 5, 3, seed=5)
    want = j.update(batch, minibatches=4, epochs=2, shuffle_seed=11)
    got = t.update(batch, minibatches=4, epochs=2, shuffle_seed=11)
    tol = dict(rtol=1e-5, atol=1e-7)
    assert_trees_close(t.params, j.params, **tol)
    adam_state = j.opt_state[0]
    assert t.opt_state.count == int(adam_state.count) == 8
    assert_trees_close(t.opt_state.mu, adam_state.mu, **tol)
    assert_trees_close(t.opt_state.nu, adam_state.nu, **tol)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert_trees_close(t.get_weights(), j.get_weights(), **tol)


def test_learner_grad_hook_seam():
    """run_sgd's grad_hook path (a learner group's allreduce seam) applies
    the hooked gradients: doubling them equals the JAX path's doubling."""
    j = j_learner.Learner(4, 2, seed=1)
    t = t_learner.Learner(4, 2, device="cpu")
    t.params = _carry(j.params)
    t.opt_state = t.opt.init(t.params)
    batch = j_learner.normalize_advantages(_ppo_batch(24, 4, 2, seed=2))
    seen = []

    def hook(grads, n):
        seen.append(n)
        return jax.tree_util.tree_map(lambda g: g * 2, grads)

    j_learner.run_sgd(j, batch, minibatches=3, epochs=1, shuffle_seed=0,
                      grad_hook=hook)
    t_learner.run_sgd(t, batch, minibatches=3, epochs=1, shuffle_seed=0,
                      grad_hook=lambda g, n: {k: {kk: vv * 2 for kk, vv
                                                  in v.items()}
                                              for k, v in g.items()})
    assert seen == [8, 8, 8]
    assert_trees_close(t.params, j.params, rtol=1e-5, atol=1e-7)


def _jax_algo(cls, cfg):
    """A JAX IMPALA/APPO's update state without its runners (the update
    seams need no cluster)."""
    algo = object.__new__(cls)
    algo.config = cfg
    algo.module = j_rlm.DiscretePolicyModule(cfg.obs_dim, cfg.n_actions)
    algo.params = algo.module.init(jax.random.PRNGKey(0))
    algo.opt = optax.adam(cfg.lr)
    algo.opt_state = algo.opt.init(algo.params)
    algo._update = jax.jit(algo._build_update())
    return algo


def impala_batch(t, n, obs_dim, n_actions, seed):
    """A [T, N] sample batch as VectorEnvRunner returns it."""
    rng = np.random.RandomState(seed)
    return {"obs": rng.randn(t, n, obs_dim).astype(np.float32),
            "actions": rng.randint(0, n_actions, (t, n)).astype(np.int32),
            "logp": -rng.rand(t, n).astype(np.float32) * 1.2,
            "values": rng.randn(t, n).astype(np.float32),
            "rewards": rng.randn(t, n).astype(np.float32),
            "dones": rng.rand(t, n) < 0.1,
            "last_values": rng.randn(n).astype(np.float32)}


def assert_adam_step_close(t_params, j_params, t_state, j_state, lr):
    """One Adam step from zero moments, port against JAX. The first
    moment is 0.1 x the gradient: at rtol 1e-5, atol 1e-5 x the leaf's
    largest (f32 sums of cancelling terms leave an absolute noise floor),
    and so is the second. The params at rtol 1e-5, atol 1e-7 wherever the
    gradient stands above that floor (|mu| > 1e-4 x the leaf's largest);
    below it, Adam's step g / (|g| + eps) follows the noise's sign, and
    there the params are held to the step's bound, |delta| <= 2 lr."""
    assert t_state.count == int(j_state.count) == 1
    for moment in ("mu", "nu"):
        want_tree = _np(getattr(j_state, moment))
        for path, g, w in zip(tree_paths(want_tree),
                              tree_leaves(getattr(t_state, moment)),
                              tree_leaves(want_tree)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{moment} {path}")
    mu = tree_leaves(_np(j_state.mu))
    for path, g, w, m in zip(tree_paths(t_params), tree_leaves(t_params),
                             tree_leaves(_np(j_params)), mu):
        g = g.detach().numpy()
        live = np.abs(m) > 1e-4 * np.abs(m).max()
        np.testing.assert_allclose(g[live], w[live], rtol=1e-5, atol=1e-7,
                                   err_msg=path)
        assert np.all(np.abs(g - w) <= 2 * lr), path
        assert (~live).mean() <= 0.02, (path, int((~live).sum()))


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_appo_update_matches_jax(algo):
    """One landed [T=32, N=4] batch through _apply_batch from the same
    weights (APPO refreshes its target after it): the metrics at rtol
    1e-5, the Adam step as assert_adam_step_close holds it."""
    jmod, tmod = ((j_impala, t_impala) if algo == "impala"
                  else (j_appo, t_appo))
    jcls = jmod.IMPALA if algo == "impala" else jmod.APPO
    tcls = tmod.IMPALAConfig if algo == "impala" else tmod.APPOConfig
    kw = dict(env_creator=Corridor, obs_dim=2, n_actions=2,
              num_env_runners=1, num_envs_per_runner=2, rollout_steps=4,
              lr=1e-2, vtrace_lam=0.9, rho_bar=0.9, c_bar=1.1)
    extra = {} if algo == "impala" else dict(target_update_freq=1)
    jcfg = (jmod.IMPALAConfig if algo == "impala" else jmod.APPOConfig)(
        **kw, **extra)
    j = _jax_algo(jcls, jcfg)
    if algo == "appo":
        j.target_params = jax.tree_util.tree_map(jnp.copy, j.params)
        j._steps_since_target = 0
    t = tcls(**kw, **extra).build(device="cpu")
    try:
        t.params = _carry(j.params)
        t.opt_state = t.opt.init(t.params)
        if algo == "appo":
            t.target_params = _carry(j.params)
        batch = impala_batch(32, 4, 2, 2, seed=10)
        want = j._apply_batch({k: jnp.asarray(v) for k, v in batch.items()})
        got = t._apply_batch(t.batch_to_device(batch))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)
        assert_adam_step_close(t.params, j.params, t.opt_state,
                               j.opt_state[0], lr=1e-2)
        if algo == "appo":
            assert t._steps_since_target == j._steps_since_target == 0
            for a, b in zip(tree_leaves(t.target_params),
                            tree_leaves(t.params)):
                assert torch.equal(a, b)
    finally:
        t.stop()


def test_bc_step_matches_jax():
    cfg = dict(obs_dim=3, n_actions=4, lr=5e-3)
    j = j_bc.BC(j_bc.BCConfig(**cfg))
    t = t_bc.BC(t_bc.BCConfig(**cfg), device="cpu")
    t.params = _carry(j.params)
    t.opt_state = t.opt.init(t.params)
    rng = np.random.RandomState(6)
    for _ in range(2):
        obs = rng.randn(20, 3).astype(np.float32)
        actions = rng.randint(0, 4, 20)
        j.params, j.opt_state, jl, ja = j._update(
            j.params, j.opt_state, jnp.asarray(obs),
            jnp.asarray(actions, jnp.int32))
        t.params, t.opt_state, tl, ta = t._update(
            t.params, t.opt_state, torch.from_numpy(obs),
            torch.from_numpy(actions))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert float(ta) == float(ja)
        assert_trees_close(t.params, j.params, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t.compute_actions(obs),
                                  j.compute_actions(obs))


class _Rows:
    """A minimal dataset (random_shuffle + iter_batches) over rows."""

    def __init__(self, rows):
        self.rows = rows

    def random_shuffle(self, seed):
        idx = np.random.RandomState(seed).permutation(len(self.rows))
        return _Rows([self.rows[i] for i in idx])

    def iter_batches(self):
        yield self.rows[:len(self.rows) // 2]
        yield self.rows[len(self.rows) // 2:]


def test_bc_clones_expert_on_a_dataset():
    rng = np.random.RandomState(0)
    rows = [{"obs": [float(x), 1.0], "action": int(x > 0.5)}
            for x in rng.rand(256)]
    algo = t_bc.BCConfig(obs_dim=2, n_actions=2, epochs=10, lr=2e-2,
                         batch_size=64).build(device="cpu")
    out = algo.train_on_dataset(_Rows(rows))
    assert out["training_iteration"] == 10
    assert out["train_accuracy"] >= 0.9, out


# ---------------- runners ----------------


def _jax_runner(mod, cls_name, *args, **kw):
    cls = getattr(mod, cls_name)._cls  # the class under the actor wrapper
    return cls(serialization.pack_callable(Corridor), *args, **kw)


def test_env_runner_sample_matches_jax():
    """From the same weights and seed: actions, rewards and dones equal;
    logp and values at rtol 1e-5 (f32 forward, numpy sampling)."""
    jp = j_models.init_policy(jax.random.PRNGKey(4), 2, 2)
    j = _jax_runner(j_env_runner, "EnvRunner", 2, 2, seed=3)
    t = t_env_runner.EnvRunner(Corridor, 2, 2, seed=3, device="cpu")
    j.set_weights(_np(jp))
    t.set_weights(_np(jp))
    for _ in range(2):
        want, got = j.sample(60), t.sample(60)
        for k in ("actions", "rewards", "dones"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["obs"], want["obs"])
        for k in ("logp", "values"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got["last_value"], want["last_value"],
                                   rtol=1e-5)
        assert got["episode_return_mean"] == want["episode_return_mean"]


def test_vector_env_runner_sample_matches_jax():
    jp = j_models.init_policy(jax.random.PRNGKey(5), 2, 2)
    j = _jax_runner(j_vector_env, "VectorEnvRunner", 2, 2, num_envs=3,
                    seed=2)
    t = t_vector_env.VectorEnvRunner(Corridor, 2, 2, num_envs=3, seed=2,
                                     device="cpu")
    j.set_weights(jp)
    t.set_weights(_np(jp))
    for _ in range(2):
        want, got = j.sample(25), t.sample(25)
        for k in ("obs", "actions", "rewards", "dones"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("logp", "values", "last_values"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert got["episode_return_mean"] == want["episode_return_mean"]


def test_softmax_sample_and_episode_returns_equal():
    logits = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    a = j_env_runner.softmax_sample(np.random.RandomState(9), logits)
    b = t_env_runner.softmax_sample(np.random.RandomState(9), logits)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    ja, ta = j_env_runner.EpisodeReturns(2), t_env_runner.EpisodeReturns(2)
    for i, (r, d) in enumerate([(1.0, False), (2.0, True), (0.5, False)]):
        ja.step(i % 2, r, d)
        ta.step(i % 2, r, d)
    assert ja.mean() == ta.mean()


# ---------------- connectors, multi-agent ----------------


def _pipelines(conn):
    return conn.Pipeline(conn.ObsNormalizer(clip=3.0), conn.FrameStack(3))


def test_connectors_equal():
    rng = np.random.RandomState(3)
    jp, tp = _pipelines(j_conn), _pipelines(t_conn)
    for step in range(12):
        x = rng.randn(4).astype(np.float32) * 5
        np.testing.assert_array_equal(tp(x), jp(x))
        if step == 5:
            jp.reset()
            tp.reset()
    js, ts = jp.state_dict(), tp.state_dict()
    assert js.keys() == ts.keys()
    np.testing.assert_array_equal(ts["0"]["mean"], js["0"]["mean"])
    np.testing.assert_array_equal(ts["0"]["m2"], js["0"]["m2"])
    clip = t_conn.ClipAction(-1.0, 2.0)
    a = rng.randn(7) * 3
    np.testing.assert_array_equal(clip(a), j_conn.ClipAction(-1.0, 2.0)(a))
    # a factory ships as the object in-process, or as a pickle blob
    assert isinstance(t_conn.pipeline_from_blob(None), t_conn.Pipeline)
    for shipped in (t_conn.FrameStack, t_conn.pack_factory(t_conn.FrameStack)):
        assert isinstance(t_conn.pipeline_from_blob(shipped), t_conn.FrameStack)
    assert t_conn.pack_factory(None) is None


class _TwoAgents:
    """Two agents on a line; agent 1 finishes after 3 joint steps, the
    episode after 5."""

    def __init__(self):
        self.t = 0

    def reset(self):
        self.t = 0
        return {"a": np.float32(0.0), "b": np.float32(1.0)}

    def step(self, actions):
        self.t += 1
        obs = {k: np.float32(self.t + (k == "b")) for k in actions}
        rew = {k: float(v) * 0.5 for k, v in actions.items()}
        dones = {"b": self.t >= 3, "__all__": self.t >= 5}
        return obs, rew, dones, {}


def test_shared_policy_wrapper_equal():
    envs = [ma.SharedPolicyWrapper(_TwoAgents()) for ma in (j_ma, t_ma)]
    outs = [[e.reset()] for e in envs]
    for i in range(14):
        for e, out in zip(envs, outs):
            o = e.step(i % 3)
            out.append(o)
            if o[2]:
                out.append(e.reset())
    assert repr(outs[0]) == repr(outs[1])
    assert issubclass(t_ma.SharedPolicyWrapper, object)
    assert t_ma.MultiAgentEnv().agent_ids == j_ma.MultiAgentEnv().agent_ids


# ---------------- the async pipeline, in process ----------------


def test_in_process_wait_returns_the_same_refs():
    import threading

    from ray_tpu_torch.serve.runtime import InProcessRuntime

    class Member:
        def __init__(self):
            self.gate = threading.Event()

        def slow(self):
            self.gate.wait(10)
            return "slow"

        def fast(self, x):
            return x

    rt = InProcessRuntime()
    a, b = (rt.spawn(Member, {}, name=n) for n in ("a", "b"))
    refs = [rt.call(a, "slow"), rt.call(b, "fast", 1), rt.call(b, "fast", 2)]
    ready, pending = rt.wait(refs, num_returns=2, timeout=10)
    assert ready == refs[1:] and pending == refs[:1]
    assert all(x is y for x, y in zip(ready, refs[1:]))
    ready, pending = rt.wait(refs[:1], num_returns=1, timeout=0.05)
    assert ready == [] and pending[0] is refs[0]
    a.obj.gate.set()
    assert rt.wait(refs, num_returns=3)[0] == refs
    assert rt.get(refs) == ["slow", 1, 2]


def test_in_process_calls_on_a_member_run_in_the_order_sent():
    """An actor runs its calls in the order they were sent, so a caller
    may send one and move on (IMPALA's ``set_weights`` before the next
    ``sample``): the first call waits on an argument still being computed
    on another member, and the calls sent after it wait their turn."""
    import threading
    import time

    from ray_tpu_torch.serve.runtime import InProcessRuntime

    class Log:
        def __init__(self):
            self.seen = []

        def add(self, x):
            self.seen.append(x)
            return len(self.seen)

    class Gate:
        def __init__(self):
            self.open = threading.Event()

        def value(self):
            self.open.wait(10)
            return "first"

    rt = InProcessRuntime()
    log = rt.spawn(Log, {}, name="log")
    gate = rt.spawn(Gate, {}, name="gate")
    first = rt.call(log, "add", rt.call(gate, "value"))
    later = [rt.call(log, "add", i) for i in range(50)]
    time.sleep(0.2)
    assert log.obj.seen == []
    gate.obj.open.set()
    assert rt.get(first, timeout=10) == 1
    assert rt.get(later, timeout=10) == list(range(2, 52))
    assert log.obj.seen == ["first", *range(50)]


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_appo_train_rounds_in_process(algo):
    """train() over in-process runners: each round waits for whichever
    sample lands first, updates, refreshes and re-arms that runner, so
    one request stays in flight per runner."""
    mod = t_impala if algo == "impala" else t_appo
    cfg = (mod.IMPALAConfig if algo == "impala" else mod.APPOConfig)(
        env_creator=Corridor, obs_dim=2, n_actions=2, num_env_runners=2,
        num_envs_per_runner=2, rollout_steps=16, lr=5e-3)
    t = cfg.build(device="cpu")
    try:
        for i in range(3):
            m = t.train()
            assert m["training_iteration"] == i + 1
            assert all(np.isfinite(v) for v in m.values())
            assert sorted(map(id, t._inflight.values())) == sorted(
                map(id, t.runners))
    finally:
        t.stop()


def _frame_stack_2():
    return t_conn.Pipeline(t_conn.FrameStack(2))


def test_ppo_in_process_with_connectors():
    """PPO over in-process runners whose env_to_module pipeline is a
    FrameStack(2) factory: obs_dim is the post-connector width."""
    algo = t_ppo.PPOConfig(env_creator=Corridor, obs_dim=4, n_actions=2,
                           num_env_runners=2, rollout_steps=32,
                           sgd_minibatches=2, sgd_epochs=1,
                           connectors=_frame_stack_2).build(device="cpu")
    try:
        seen = []
        update = algo.learner.update
        algo.learner.update = lambda batch, **kw: (seen.append(batch),
                                                   update(batch, **kw))[1]
        for i in range(2):
            m = algo.train()
            assert m["training_iteration"] == i + 1
            assert seen[-1]["obs"].shape == (64, 4)
            assert all(np.isfinite(v) for v in m.values())
    finally:
        algo.stop()
