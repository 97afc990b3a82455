"""The port's off-policy RL (replay, DQN, SAC) against ray_tpu.rl on the
CPU.

The same seeded numpy inputs, and JAX's weights carried across with
``models.from_jax_params``, go through the JAX function and its port
counterpart: the replay buffer's adds and samples (equal), ``huber_loss``
(rtol 1e-6, on both sides of δ and at it), DQN's double-DQN update (loss
and |td| at rtol 1e-5, params after 4 steps under the Adam rule below),
the QEnvRunner's ε-greedy sampling (equal), SAC's squashed-Gaussian
sample (rtol 1e-5, with rows whose log_std is clipped and whose tanh is
near or at ±1) and its loss terms, three SACLearner updates (each
step's gradient at rtol 1e-5 against JAX's, then JAX's gradient applied,
so both label groups, log_alpha, the moments and the polyak targets hold
at rtol 1e-5 on one trajectory; a free run within the steps' bound),
where XLA's tanh allows (see _sac_actor_inputs), and the
GaussianEnvRunner's warm-up. JAX's algorithms are driven
without a cluster: the update functions through stubs that carry what
they read, the samplers through the plain classes under their actor
wrappers.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu._private import serialization
from ray_tpu.rl import dqn as j_dqn
from ray_tpu.rl import models as j_models
from ray_tpu.rl import replay as j_replay
from ray_tpu.rl import sac as j_sac
from ray_tpu_torch.rl import dqn as t_dqn
from ray_tpu_torch.rl import envs as t_envs
from ray_tpu_torch.rl import replay as t_replay
from ray_tpu_torch.rl import sac as t_sac
from ray_tpu_torch.rl.learner import batch_to
from ray_tpu_torch.train import optim as t_optim
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths
from tests.test_rl import Corridor
from tests.test_torch_rl import _carry, _np, assert_trees_close

F32 = dict(rtol=1e-5, atol=1e-6)  # forwards and losses, f32 on both sides
FLOOR_SHARE = 0.02  # tests/test_torch_rl.py's assert_adam_step_close


def assert_adam_steps_close(t_params, j_params, t_grads, j_grads, lr_of):
    """Port against JAX after len(grads) Adam steps from the same weights,
    the rule of tests/test_torch_rl.py's assert_adam_step_close over
    several steps. Each step's gradient: rtol 1e-5, atol 1e-5 x the leaf's
    largest (f32 sums of cancelling terms leave an absolute floor). The
    params: rtol 1e-5, atol 1e-7 wherever every step's gradient stands
    above that floor (|g| > 1e-4 x the leaf's largest) or is 0 at every
    step. Below the floor Adam's g / (|g| + eps) follows the noise's
    sign, so there an element may miss rtol: it is held to the steps'
    bound, |delta| <= 2 lr a step, and at most 2% of a leaf may be held
    so. (Over several steps more than 2% of a leaf can cross the floor
    at some step even between identical runs, so the cap counts the
    elements that miss.) ``lr_of(path)``: the leaf's learning rate."""
    assert len(t_grads) == len(j_grads)
    held = {}
    for step, (tg, jg) in enumerate(zip(t_grads, j_grads)):
        jg = _np(jg)
        assert tree_paths(tg) == tree_paths(jg)
        for path, g, w in zip(tree_paths(jg), tree_leaves(tg),
                              tree_leaves(jg)):
            g = g.detach().numpy()
            scale = float(np.abs(w).max()) or 1.0
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"grad step {step} {path}")
            live, still = held.get(path, (True, True))
            held[path] = (live & (np.abs(w) > 1e-4 * scale), still & (w == 0))
    steps = len(t_grads)
    for path, g, w in zip(tree_paths(t_params), tree_leaves(t_params),
                          tree_leaves(_np(j_params))):
        g = g.detach().numpy()
        live, still = held[path]
        m = np.broadcast_to(live | still, w.shape)
        np.testing.assert_allclose(g[m], w[m], rtol=1e-5, atol=1e-7,
                                   err_msg=path)
        assert np.all(np.abs(g - w) <= 2 * lr_of(path) * steps), path
        missed = ~np.isclose(g, w, rtol=1e-5, atol=1e-7)
        assert missed.mean() <= FLOOR_SHARE, (path, int(missed.sum()))


class _Recording:
    """An optimizer (optax's or the port's) that keeps each gradient it is
    given."""

    def __init__(self, opt, to_np):
        self.opt, self.to_np, self.grads = opt, to_np, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(self.to_np(grads))
        return self.opt.update(grads, state, params)


# ---------------- replay ----------------


@pytest.mark.parametrize("action_dim", [None, 2], ids=["discrete",
                                                       "continuous"])
def test_replay_buffer_matches_jax(action_dim):
    """Adds past the capacity (a wrap, and one add larger than the ring)
    then seeded samples: every column equal."""
    rng = np.random.RandomState(3)
    bufs = [mod.ReplayBuffer(capacity=24, obs_dim=3, seed=5,
                             action_dim=action_dim)
            for mod in (j_replay, t_replay)]
    for n in (10, 9, 31, 4):
        obs = rng.randn(n, 3).astype(np.float32)
        acts = (rng.randint(0, 4, n).astype(np.int32) if action_dim is None
                else rng.randn(n, action_dim).astype(np.float32))
        cols = (obs, acts, rng.randn(n).astype(np.float32), rng.rand(n) < 0.3,
                rng.randn(n, 3).astype(np.float32))
        for b in bufs:
            b.add_batch(*cols)
        assert len(bufs[0]) == len(bufs[1])
        for _ in range(2):
            want, got = (b.sample(7) for b in bufs)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].dtype == want[k].dtype, k


# ---------------- DQN ----------------


def test_huber_loss_matches_jax():
    """Values at rtol 1e-6, and gradients, on both sides of δ and at it
    (δ = 1, optax's default, and δ = 0.5)."""
    x = np.array([-3.0, -1.0, -0.999, -0.5, -1e-3, 0.0, 2e-4, 0.5, 0.999,
                  1.0, 1.001, 2.5, 40.0], np.float32)
    for delta in (1.0, 0.5):
        want, want_g = jax.value_and_grad(
            lambda v: optax.huber_loss(v, delta=delta).sum())(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        got = t_dqn.huber_loss(xt, delta)
        got.sum().backward()
        np.testing.assert_allclose(
            got.detach().numpy(), np.asarray(optax.huber_loss(x, delta=delta)),
            rtol=1e-6)
        np.testing.assert_allclose(float(got.detach().sum()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6)


def _dqn_stubs(cfg):
    """A JAX and a port stand-in for ``self`` of DQN._update_fn: the
    config and a recording Adam."""
    j = types.SimpleNamespace(config=cfg, opt=_Recording(
        optax.adam(cfg.lr), _np))
    t = types.SimpleNamespace(config=cfg, opt=_Recording(
        t_optim.adam(cfg.lr), lambda g: g))
    return j, t


def test_dqn_update_matches_jax():
    """4 double-DQN steps from JAX's weights (online and a different
    target) on minibatches of one seeded ReplayBuffer: loss and mean |td|
    at rtol 1e-5 each step, then the params and every step's gradient
    under assert_adam_steps_close."""
    cfg = j_dqn.DQNConfig(obs_dim=4, n_actions=3, lr=5e-3, gamma=0.9)
    jp = j_models.init_policy(jax.random.PRNGKey(cfg.seed), 4, 3)
    jt = j_models.init_policy(jax.random.PRNGKey(11), 4, 3)
    j_opt_state = optax.adam(cfg.lr).init(jp)
    tp, tt = _carry(jp), _carry(jt)
    j_self, t_self = _dqn_stubs(cfg)
    t_opt_state = t_self.opt.init(tp)
    buf = t_replay.ReplayBuffer(256, 4, seed=2)
    rng = np.random.RandomState(8)
    buf.add_batch(rng.randn(200, 4).astype(np.float32),
                  rng.randint(0, 3, 200).astype(np.int32),
                  rng.randn(200).astype(np.float32), rng.rand(200) < 0.2,
                  rng.randn(200, 4).astype(np.float32))
    for step in range(4):
        mb = buf.sample(cfg.train_batch_size)
        jp, j_opt_state, j_loss, j_td = j_dqn.DQN._update_fn(
            j_self, jp, jt, j_opt_state, {k: jnp.asarray(v)
                                          for k, v in mb.items()})
        tp, t_opt_state, t_loss, t_td = t_dqn.DQN._update_fn(
            t_self, tp, tt, t_opt_state, batch_to(mb, t_dqn._BATCH_KEYS,
                                                  "cpu"))
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5,
                                   err_msg=f"loss {step}")
        np.testing.assert_allclose(float(t_td), float(j_td), rtol=1e-5,
                                   err_msg=f"td {step}")
    assert t_opt_state.count == int(j_opt_state[0].count) == 4
    assert_adam_steps_close(tp, jp, t_self.opt.grads, j_self.opt.grads,
                            lambda path: cfg.lr)


def test_q_env_runner_matches_jax():
    """From JAX's weights and the same seed, the ε-greedy runner's samples
    are equal (ε = 0.4: both branches taken)."""
    jp = j_models.init_policy(jax.random.PRNGKey(4), 2, 2)
    blob = serialization.pack_callable(Corridor)
    j = j_dqn.QEnvRunner._cls(blob, seed=3)  # the class under the actor
    t = t_dqn.QEnvRunner(Corridor, seed=3, device="cpu")
    j.set_weights(jp)
    assert t.set_weights(_np(jp))
    for _ in range(2):
        want, got = j.sample(40, 0.4), t.sample(40, 0.4)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------- SAC ----------------


def _sac_actor_inputs(rows=24, obs_dim=3, action_dim=2, seed=0):
    """JAX's actor with its log_std head scaled so that some rows clip
    below -8 and some above 2; obs; and per-row noise that puts the
    pre-squash u = mu + std * noise where tanh is well conditioned in
    f32: within [-3, 3], at ±3.3 (tanh within 3e-3 of ±1) or past ±10
    (tanh at ±1 in f32). In between, 1 - tanh(u)**2 shrinks to the f32
    spacing of tanh near 1, where log(1 - a**2 + 1e-6) turns a one-ulp
    difference of tanh into up to 0.1 of log-prob; XLA's CPU tanh is
    up to 4.3 ulps off and torch's within 0.6, so the two differ there
    (ROADMAP Queue 3)."""
    rng = np.random.RandomState(seed)
    params = _np(j_sac.init_sac_params(jax.random.PRNGKey(seed), obs_dim,
                                       action_dim, hidden=32))
    actor = params["actor"]
    actor["log_std"]["w"] = actor["log_std"]["w"] * 12.0
    obs = (rng.randn(rows, obs_dim) * 2).astype(np.float32)
    mu, log_std = (np.asarray(x, np.float64) for x in j_sac.actor_dist(
        actor, jnp.asarray(obs)))
    u = rng.uniform(-3, 3, (rows, action_dim))
    u[:4] = 3.3 * np.sign(u[:4])
    u[4:8] = 12.0 * np.sign(u[4:8])
    noise = ((u - mu) / np.exp(log_std)).astype(np.float32)
    return params, obs, noise


U_NEAR, U_SATURATED = 3.3, 12.0  # |u| bounds of _sac_actor_inputs


def _conditioned(actor, obs, noise):
    """``noise`` moved, row by row, so that u = mu + std * noise of JAX's
    ``actor`` stays within ±U_NEAR (see _sac_actor_inputs for why). The
    gradient tests saturate no row: where tanh is ±1 in f32 the values
    agree, but the backward multiplies each side's rounding of 1 - a**2
    by 2 / (1 - a**2 + 1e-6), up to 2e6."""
    mu, log_std = (np.asarray(x, np.float64) for x in j_sac.actor_dist(
        actor, jnp.asarray(obs)))
    std = np.exp(log_std)
    u = np.clip(mu + std * noise, -U_NEAR, U_NEAR)
    return ((u - mu) / std).astype(np.float32)


def _sac_batch(n, obs_dim, action_dim, seed, actor):
    rng = np.random.RandomState(seed)
    batch = {
        "obs": rng.randn(n, obs_dim).astype(np.float32),
        "actions": np.tanh(rng.randn(n, action_dim)).astype(np.float32),
        "rewards": rng.randn(n).astype(np.float32),
        "next_obs": rng.randn(n, obs_dim).astype(np.float32),
        "dones": rng.rand(n) < 0.1,
    }
    batch["noise_pi"] = _conditioned(actor, batch["obs"],
                                     rng.randn(n, action_dim))
    batch["noise_next"] = _conditioned(actor, batch["next_obs"],
                                       rng.randn(n, action_dim))
    return batch


def _sac_pair(obs_dim, action_dim, **kw):
    """JAX's SACLearner and the port's from JAX's weights and targets."""
    j = j_sac.SACLearner(obs_dim, action_dim, seed=7, **kw)
    t = t_sac.SACLearner(obs_dim, action_dim, seed=7, device="cpu", **kw)
    t.params = _carry(j.params)
    t.target = _carry(j.target)
    t.opt_state = {label: t.opt[label].init(t._part(t.params, keys))
                   for label, keys in (("actor", t_sac.ACTOR_KEYS),
                                       ("critic", t_sac.CRITIC_KEYS))}
    return j, t


def test_sac_loss_terms_match_jax():
    """_loss's total and each term at rtol 1e-5, atol 1e-6 (the actor
    term is a mean of O(1) summands that cancel to O(0.01), which keeps
    f32's absolute error); its gradient (every
    leaf, both label groups and log_alpha) at rtol 1e-5, atol 1e-5 x the
    leaf's largest. The targets differ from the params (a polyak-moved
    copy), log_alpha is not 0, and dones and reward_scale take part; the
    noise puts some rows' tanh within 3e-3 of ±1."""
    j, t = _sac_pair(3, 2, reward_scale=2.0, gamma=0.9)
    shifted = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01, j.target)
    params = dict(j.params, log_alpha=jnp.float32(-0.3))
    batch = _sac_batch(48, 3, 2, seed=1, actor=params["actor"])
    (want, want_m), want_g = jax.value_and_grad(j._loss, has_aux=True)(
        params, shifted, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = batch_to(batch, t_sac._BATCH_KEYS, "cpu")
    grads, got_m = t._grad_fn(_carry(params), _carry(shifted), tb)
    got, _ = t._loss(_carry(params), _carry(shifted), tb)
    np.testing.assert_allclose(float(got), float(want), **F32)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   err_msg=k, **F32)
    want_g = _np(want_g)
    assert tree_paths(grads) == tree_paths(want_g)
    for path, g, w in zip(tree_paths(grads), tree_leaves(grads),
                          tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * (np.abs(w).max() or 1.0),
                                   err_msg=path)


def test_sac_log_prob_near_saturation_is_closer_to_f64_than_jax():
    """Between |u| = U_NEAR and saturation, log(1 - tanh(u)**2 + 1e-6)
    magnifies tanh's last-ulp error (XLA's CPU tanh is up to 4.3 ulps
    off, torch's within 0.6): there the port's log-prob stands nearer the
    float64 value than JAX's, by at least half JAX's error on the worst
    row (the deviation recorded in ROADMAP Queue 3)."""
    u = np.linspace(5.0, 8.0, 61).astype(np.float32)[:, None]
    actor = {"h1": {"w": np.zeros((1, 4), np.float32),
                    "b": np.zeros(4, np.float32)},
             "h2": {"w": np.zeros((4, 4), np.float32),
                    "b": np.zeros(4, np.float32)},
             "mu": {"w": np.zeros((4, 1), np.float32),
                    "b": np.zeros(1, np.float32)},
             "log_std": {"w": np.zeros((4, 1), np.float32),
                         "b": np.zeros(1, np.float32)}}
    obs = np.zeros((len(u), 1), np.float32)
    _, want = j_sac.sample_action_with_noise(actor, jnp.asarray(obs),
                                             jnp.asarray(u), 1.0)
    _, got = t_sac.sample_action_with_noise(
        _carry(actor), torch.from_numpy(obs), torch.from_numpy(u), 1.0)
    u64 = u[:, 0].astype(np.float64)
    exact = (-0.5 * (u64 ** 2 + np.log(2 * np.pi))
             - np.log(1.0 - np.tanh(u64) ** 2 + 1e-6))
    j_err = np.abs(np.asarray(want, np.float64) - exact)
    t_err = np.abs(got.numpy().astype(np.float64) - exact)
    worst = int(np.argmax(j_err))
    assert t_err[worst] <= 0.5 * j_err[worst], (t_err[worst], j_err[worst])
    assert t_err.max() < j_err.max()


def test_sac_learner_update_matches_jax():
    """3 SACLearner.update steps from JAX's weights on a batch with given
    noise. The port's gradient at each step against JAX's at rtol 1e-5,
    atol 1e-5 x the leaf's largest; the step then applies JAX's gradient
    (the grad_hook seam), so the two runs stay on one trajectory and the
    params, the polyak targets and each label group's Adam moments after
    3 steps hold at rtol 1e-5, atol 1e-7 (moments: atol 1e-5 x the leaf's
    largest), both label groups and log_alpha included. A free run of the
    port (its own gradients) ends within the steps' bound of JAX's,
    |delta| <= 2 lr a step (actor at lr, q1/q2/log_alpha at 3·lr): a
    gradient's relative error, which the check above allows up to 10% on
    elements near the floor, carries into Adam's later steps."""
    lr = 3e-4
    j, t = _sac_pair(3, 1, lr=lr)
    _, free = _sac_pair(3, 1, lr=lr)
    batch = _sac_batch(64, 3, 1, seed=4, actor=j.params["actor"])
    j_grads, t_grads = [], []
    for step in range(3):
        j.update({k: jnp.asarray(v) for k, v in batch.items()},
                 grad_hook=lambda g, n: j_grads.append(_np(g)) or g)
        t.update(batch, grad_hook=lambda g, n: t_grads.append(g) or _carry(
            j_grads[step]))
        free.update(batch)
    for step, (g, w) in enumerate(zip(t_grads, j_grads)):
        for path, a, b in zip(tree_paths(g), tree_leaves(g), tree_leaves(w)):
            np.testing.assert_allclose(
                a.numpy(), b, rtol=1e-5, atol=1e-5 * (np.abs(b).max() or 1.0),
                err_msg=f"grad step {step} {path}")
    assert_trees_close(t.params, j.params, rtol=1e-5, atol=1e-7)
    assert_trees_close(t.target, j.target, rtol=1e-5, atol=1e-7)
    for label in ("actor", "critic"):
        inner = j.opt_state.inner_states[label].inner_state[0]
        state = t.opt_state[label]
        assert state.count == int(inner.count) == 3
        for moment in ("mu", "nu"):
            want = _np({k: v for k, v in getattr(inner, moment).items()
                        if not isinstance(v, optax.MaskedNode)})
            got = getattr(state, moment)
            assert tree_paths(got) == tree_paths(want)
            for path, g, w in zip(tree_paths(got), tree_leaves(got),
                                  tree_leaves(want)):
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=1e-5,
                    atol=1e-5 * (np.abs(w).max() or 1.0),
                    err_msg=f"{label} {moment} {path}")
    assert float(t.params["log_alpha"]) != 0.0
    want = _np(j.params)
    for path, g, w in zip(tree_paths(free.params), tree_leaves(free.params),
                          tree_leaves(want)):
        bound = 2 * (lr if path.startswith("actor") else 3 * lr) * 3
        assert np.all(np.abs(g.numpy() - w) <= bound), path


def test_sac_with_noise_and_act():
    """Noise comes from the learner's generator (seed + 1), so two
    learners of one seed draw the same; given noise is kept; act()
    returns actions within the scale, the deterministic one tanh(mu)."""
    a = t_sac.SACLearner(3, 2, seed=5, action_scale=2.0, device="cpu")
    b = t_sac.SACLearner(3, 2, seed=5, action_scale=2.0, device="cpu")
    batch = {"obs": np.zeros((6, 3), np.float32)}
    na, nb = a.with_noise(batch), b.with_noise(batch)
    np.testing.assert_array_equal(na["noise_pi"], nb["noise_pi"])
    assert na["noise_pi"].shape == na["noise_next"].shape == (6, 2)
    assert not np.array_equal(na["noise_pi"], na["noise_next"])
    assert a.with_noise(na) is na
    obs = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    act = a.act(obs)
    assert act.shape == (5, 2) and float(act.abs().max()) <= 2.0
    mu, _ = t_sac.actor_dist(a.params["actor"], torch.from_numpy(obs))
    torch.testing.assert_close(a.act(obs, deterministic=True),
                               torch.tanh(mu) * 2.0)


def test_gaussian_env_runner_warmup_matches_jax():
    """The uniform warm-up and the connectors (ObsNormalizer, ClipAction)
    on PendulumEnv: with random_until covering the run, both runners'
    samples are equal (rtol 1e-6 for the normalized obs); past it, the
    port's policy actions lie within the scale and ``done`` follows the
    truncated rule."""
    from ray_tpu.rl import connectors as j_conn
    from ray_tpu_torch.rl import connectors as t_conn

    j = j_sac.GaussianEnvRunner._cls(
        serialization.pack_callable(t_envs.PendulumEnv), 2.0,
        j_conn.pack_factory(lambda: j_conn.Pipeline(j_conn.ObsNormalizer())),
        seed=3)
    t = t_sac.GaussianEnvRunner(
        t_envs.PendulumEnv, 2.0,
        lambda: t_conn.Pipeline(t_conn.ObsNormalizer()), seed=3,
        device="cpu")
    want, got = j.sample(210, random_until=500), t.sample(210, random_until=500)
    for k in ("actions", "rewards", "dones"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("obs", "next_obs"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["episode_return_mean"] == pytest.approx(
        want["episode_return_mean"], rel=1e-9)
    assert not got["dones"].any()  # Pendulum's 200-step end is truncation
    params = t_sac.init_sac_params(0, 3, 1, device="cpu")
    t.set_weights(params["actor"])
    out = t.sample(16, random_until=0)
    assert out["actions"].shape == (16, 1)
    assert np.abs(out["actions"]).max() <= 2.0
    assert t.connector_state() == t.obs_pipe.state_dict()


def test_init_sac_params_tree_and_law():
    """JAX's keys and shapes; N(0, 1/in) weights, zero biases, log_alpha a
    scalar 0; the same seed gives the same weights."""
    want = j_sac.init_sac_params(jax.random.PRNGKey(0), 5, 2)
    got = t_sac.init_sac_params(0, 5, 2, device="cpu")
    assert tree_paths(got) == tree_paths(_np(want))
    for path, g, w in zip(tree_paths(got), tree_leaves(got),
                          tree_leaves(_np(want))):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
    assert got["log_alpha"].shape == () and float(got["log_alpha"]) == 0.0
    w = got["q1"]["h2"]["w"]
    assert abs(float(w.std()) * np.sqrt(128) - 1.0) < 0.05
    again = t_sac.init_sac_params(0, 5, 2, device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(again)):
        assert torch.equal(a, b)


# ---------------- the algorithms, in process ----------------


def test_dqn_runs_in_process():
    """DQN on the corridor with two in-process runners: the buffer fills,
    updates start at learning_starts, the target syncs every
    target_update_period iterations, and the runners hold the learner's
    weights after each iteration."""
    algo = t_dqn.DQNConfig(env_creator=Corridor, obs_dim=2, n_actions=2,
                           num_env_runners=2, rollout_steps=32,
                           learning_starts=64, grad_steps_per_iteration=4,
                           target_update_period=2, lr=2e-3,
                           seed=3).build(device="cpu")
    try:
        hist = [algo.train() for _ in range(3)]
        assert [m["buffer_size"] for m in hist] == [64, 128, 192]
        assert all(m["loss"] > 0 for m in hist)
        assert hist[0]["epsilon"] == 1.0 > hist[1]["epsilon"]
        # after iteration 2 the target was synced; iteration 3 moved the
        # Q head (the value head, which DQN does not train, stays equal)
        for path, a, b in zip(tree_paths(algo.params),
                              tree_leaves(algo.target_params),
                              tree_leaves(algo.params)):
            assert torch.equal(a, b) == path.startswith("vf"), path
        rt = algo.runtime
        for r in algo.runners:
            for a, b in zip(tree_leaves(r.obj.params),
                            tree_leaves(algo.params)):
                assert torch.equal(a, b)
        assert all(np.isfinite(v) for m in hist for v in m.values())
    finally:
        algo.stop()
    assert all(r.dead for r in algo.runners) and rt.is_initialized()


def test_sac_runs_in_process():
    """SAC on PendulumEnv with a connector pipeline: warm-up iterations
    fill the buffer without updates, then grad steps report finite
    metrics and the runner holds the learner's actor."""
    from ray_tpu_torch.rl import connectors as t_conn

    algo = t_sac.SACConfig(
        env_creator=t_envs.PendulumEnv, rollout_steps=32, learning_starts=64,
        random_steps=64, grad_steps_per_iteration=2, train_batch_size=16,
        connectors=lambda: t_conn.Pipeline(t_conn.ObsNormalizer()),
    ).build(device="cpu")
    try:
        hist = [algo.train() for _ in range(3)]
        assert "critic_loss" not in hist[0]
        assert {"critic_loss", "actor_loss", "alpha",
                "entropy"} <= set(hist[2])
        assert hist[2]["total_steps"] == 96
        assert all(np.isfinite(v) for m in hist for v in m.values())
        runner = algo.runners[0].obj
        for a, b in zip(tree_leaves(runner.actor),
                        tree_leaves(algo.learner.params["actor"])):
            assert torch.equal(a, b)
    finally:
        algo.stop()
