"""The port's policy server over the in-process runtime's HTTP ingress,
against ray_tpu.rl.policy_server's replica on the CPU.

The port's ``PolicyServer`` deploys through ``InProcessRuntime.deploy``
and the stdlib ``PolicyClient`` speaks to it over HTTP. Checked: every
command and its reply shape against JAX's ``_PolicyDeploymentImpl``
driven directly with the same requests (greedy actions equal from JAX's
weights carried across; explored actions' logp equal to the module's
log-softmax at rtol 1e-5, as the keys differ), the 500 reply on an
unknown command and the 404 on an unknown route, a weight push
flipping the deterministic action (JAX's
test_policy_server_weight_push_changes_actions), ``drain_samples``'s
PPO-ready arrays feeding the port's Learner, and the ingress stopping
with its last deployment.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import serialization
from ray_tpu.rl import policy_server as j_ps
from ray_tpu.rl import rl_module as j_rlm
from ray_tpu_torch.rl import learner as t_learner
from ray_tpu_torch.rl import policy_server as t_ps
from ray_tpu_torch.rl import rl_module as t_rlm
from ray_tpu_torch.serve.runtime import InProcessRuntime
from tests.test_torch_rl import _carry, _np


class Corridor:
    """tests/test_rl_policy_server.py's corridor (40-step limit)."""

    N = 5

    def __init__(self):
        self.pos = 0
        self.t = 0

    def reset(self):
        self.pos = 0
        self.t = 0
        return self._obs()

    def _obs(self):
        return np.array([self.pos / self.N, 1.0], np.float32)

    def step(self, action):
        self.t += 1
        self.pos = max(0, self.pos + (1 if action == 1 else -1))
        done = self.pos >= self.N or self.t >= 40
        reward = 1.0 if self.pos >= self.N else -0.05
        return self._obs(), reward, done, {}


def _run_episodes(client, n):
    env = Corridor()
    returns = []
    for _ in range(n):
        eid = client.start_episode()
        obs = env.reset()
        total = 0.0
        while True:
            a = client.get_action(eid, obs)
            obs, r, done, _ = env.step(a)
            client.log_returns(eid, r)
            total += r
            if done:
                client.end_episode(eid, obs)
                break
        returns.append(total)
    return returns


def _post(address, route, body):
    conn = http.client.HTTPConnection(*address, timeout=30)
    try:
        conn.request("POST", route, json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        conn.close()


@pytest.fixture
def jax_policy():
    module = j_rlm.DiscretePolicyModule(obs_dim=2, n_actions=2)
    return module, module.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("explore", [False, True], ids=["greedy", "explore"])
def test_commands_match_jax_replica(jax_policy, explore):
    """The same requests through the port's server (HTTP) and JAX's
    replica (called directly): equal episode ids, reply keys, greedy
    actions, rewards and drained episodes; an explored action's logp is
    the module's log-softmax at it (rtol 1e-5)."""
    jmod, jparams = jax_policy
    j = j_ps._PolicyDeploymentImpl(serialization.pack_payload(jmod),
                                   serialization.pack_payload(jparams),
                                   explore=explore, seed=0)
    tmod = t_rlm.DiscretePolicyModule(obs_dim=2, n_actions=2)
    server = t_ps.PolicyServer(tmod, _carry(jparams), name="cmds",
                               route="/cmds", explore=explore, device="cpu")
    client = t_ps.PolicyClient(server.address, route="/cmds")
    try:
        rng = np.random.RandomState(2)
        for done in range(3):
            eid = client.start_episode()
            assert eid == j({"cmd": "start_episode"})["episode_id"]
            for _ in range(5):
                obs = rng.randn(2).astype(np.float32)
                got = client._post({"cmd": "get_action", "episode_id": eid,
                                    "obs": obs.tolist()})
                want = j({"cmd": "get_action", "episode_id": eid,
                          "obs": obs.tolist()})
                assert set(got) == set(want) == {"action", "logp"}
                logits = np.asarray(jmod.forward_train(
                    jparams, jnp.asarray(obs[None]))["logits"])[0]
                if explore:
                    lsm = np.asarray(jax.nn.log_softmax(logits))
                    np.testing.assert_allclose(got["logp"],
                                               lsm[got["action"]], rtol=1e-5)
                else:
                    assert got == want and got["logp"] == 0.0
                r = float(rng.rand())
                for reply in (client._post({"cmd": "log_returns",
                                            "episode_id": eid, "reward": r}),
                              j({"cmd": "log_returns", "episode_id": eid,
                                 "reward": r})):
                    assert reply == {"ok": True}
            stats = server.runtime.get(server.runtime.call(server.handle,
                                                           "stats"))
            assert stats == j.stats() == {"open_episodes": 1,
                                          "complete_episodes": done}
            client.end_episode(eid, np.zeros(2, np.float32))
            assert j({"cmd": "end_episode", "episode_id": eid,
                      "obs": [0.0, 0.0]}) == {"ok": True}
        got_eps = server.runtime.get(server.runtime.call(server.handle,
                                                         "drain_samples"))
        want_eps = j.drain_samples()
        assert len(got_eps) == len(want_eps) == 3
        for g, w in zip(got_eps, want_eps):
            assert set(g) == set(w)
            assert g["rewards"] == w["rewards"]
            assert g["final_obs"] == w["final_obs"] == [0.0, 0.0]
            np.testing.assert_allclose(g["obs"], w["obs"], rtol=0)
            if not explore:
                assert g["actions"] == w["actions"]
        assert server.drain_samples() is None
    finally:
        server.shutdown()


def test_error_paths_and_ingress_lifetime():
    """An unknown command answers 500 with the error (PolicyClient raises
    it); an unknown route 404; a second replica is refused; killing the
    last deployment stops the ingress, and a new deployment starts
    one."""
    rt = InProcessRuntime()
    mod = t_rlm.DiscretePolicyModule(2, 2)
    server = t_ps.PolicyServer(mod, mod.init(0, device="cpu"), route="/p",
                               runtime=rt, device="cpu")
    try:
        client = t_ps.PolicyClient(server.address, route="/p")
        with pytest.raises(RuntimeError, match="500.*unknown policy server"):
            client._post({"cmd": "reset_everything"})
        with pytest.raises(RuntimeError, match="500.*KeyError"):
            client.get_action("ep_404", [0.0, 1.0])
        status, body = _post(server.address, "/nowhere", {"cmd": "x"})
        assert status == 404 and "no route" in body["error"]
        with pytest.raises(ValueError, match="one replica"):
            rt.deploy(t_ps._PolicyDeploymentImpl, name="two",
                      route_prefix="/two", init_args=(mod, {}),
                      num_replicas=2, max_concurrent_queries=1)
        # the longest prefix wins, and a sub-path reaches its deployment
        inner = t_ps.PolicyServer(mod, mod.init(1, device="cpu"),
                                  name="inner", route="/p/inner", runtime=rt,
                                  device="cpu")
        assert inner.address == server.address
        eid = t_ps.PolicyClient(server.address, route="/p/inner/x"
                                ).start_episode()
        assert eid == "ep_0"
        assert rt.get(rt.call(inner.handle, "stats"))["open_episodes"] == 1
        assert rt.get(rt.call(server.handle, "stats"))["open_episodes"] == 0
        inner.shutdown()
    finally:
        server.shutdown()
    with pytest.raises(RuntimeError, match="ingress is not up"):
        rt.http_address()
    with pytest.raises(OSError):
        _post(server.address, "/p", {"cmd": "start_episode"})
    again = t_ps.PolicyServer(mod, mod.init(0, device="cpu"), route="/p",
                              runtime=rt, device="cpu")
    try:
        assert t_ps.PolicyClient(again.address, route="/p").start_episode()
    finally:
        again.shutdown()


def test_weight_push_changes_actions(jax_policy):
    """JAX's test_policy_server_weight_push_changes_actions on the port:
    a bias push to the other action flips the greedy action."""
    jmod, jparams = jax_policy
    mod = t_rlm.DiscretePolicyModule(obs_dim=2, n_actions=2)
    params = _carry(jparams)
    server = t_ps.PolicyServer(mod, params, name="det_policy", route="/det",
                               explore=False, device="cpu")
    client = t_ps.PolicyClient(server.address, route="/det")
    obs = np.array([0.3, 1.0], np.float32)

    def served_action():
        eid = client.start_episode()
        a = client.get_action(eid, obs)
        client.end_episode(eid)
        return a

    try:
        base = served_action()
        assert base == int(np.asarray(jmod.forward_inference(
            jparams, jnp.asarray(obs[None])))[0])
        forced = {k: dict(v) for k, v in params.items()}
        bias = torch.zeros(2)
        bias[1 - base] = 50.0
        forced["pi"]["b"] = bias
        server.set_weights(forced)
        assert served_action() == 1 - base
    finally:
        server.shutdown()


def test_drain_samples_feed_the_learner():
    """16 corridor episodes through the client: drain_samples gives
    PPO-ready arrays (obs [N, 2] f32, actions int32, logp <= 0, dones
    true exactly at each episode's end, one return per episode) that a
    Learner update consumes."""
    mod = t_rlm.DiscretePolicyModule(obs_dim=2, n_actions=2)
    lrn = t_learner.Learner(2, 2, module=mod, lr=5e-3, device="cpu")
    server = t_ps.PolicyServer(mod, lrn.params, name="corridor",
                               route="/corridor", seed=0, device="cpu")
    client = t_ps.PolicyClient(server.address, route="/corridor")
    try:
        rets = _run_episodes(client, 16)
        batch = server.drain_samples()
        n = len(batch["actions"])
        assert batch["obs"].shape == (n, 2) and batch["obs"].dtype == np.float32
        assert batch["actions"].dtype == np.int32
        assert batch["logp"].shape == batch["rewards"].shape == (n,)
        assert np.all(batch["logp"] <= 0.0)
        assert batch["dones"].dtype == bool and batch["dones"].sum() == 16
        assert batch["dones"][-1]
        np.testing.assert_allclose(batch["episode_returns"], rets, rtol=1e-6)
        with torch.no_grad():
            values = mod.forward_train(
                lrn.params, torch.from_numpy(batch["obs"]))["vf"].numpy()
        adv, ret = t_learner.compute_gae(batch["rewards"], values,
                                         batch["dones"], 0.0)
        m = lrn.update({**batch, "advantages": adv, "returns": ret},
                       minibatches=2, epochs=1)
        assert all(np.isfinite(v) for v in m.values())
        server.set_weights(lrn.params)
        assert len(_run_episodes(client, 1)) == 1
    finally:
        server.shutdown()


def test_client_is_stdlib_only():
    """PolicyClient sends plain floats from lists, tuples, numpy arrays
    and tensors alike."""
    assert t_ps._floats([[1, 2], (3.5,)]) == [1.0, 2.0, 3.5]
    assert t_ps._floats(np.arange(3, dtype=np.float32)) == [0.0, 1.0, 2.0]
    assert t_ps._floats(torch.tensor([[0.5]])) == [0.5]
    assert t_ps._floats(2) == [2.0]
    assert _np({"a": jnp.ones(1)})["a"].tolist() == [1.0]
