"""The ray_tpu runtime hosts the port's learner group, policy server,
checkpoint shipping and DQN.

The runtime value is tests/test_torch_rl_hosted.py's ``RayRuntime`` with
the calls this slice adds: ``collective`` (ray_tpu's
``create_collective_group``, and callables that run
``ray_tpu.collective.allreduce`` inside each actor), ``deploy`` and
``http_address`` (``ray_tpu.serve.run`` and its HTTP proxy), ``get``
under ``fetch_context`` for its ``fetch_tags``, and ``put(owned=True)``
as a store put (``_inline=False``). On one cluster:

- the port's ``LearnerGroup(2)`` on ray_tpu actors beside JAX's
  ``LearnerGroup(2)``, from JAX's weights, one 64-row batch
  (minibatches=1, epochs=3): params at rtol 1e-4, atol 1e-5 (JAX's
  tolerances, tests/test_rl_learner_group.py:54);
- the port's ``PolicyServer`` deployed through ray_tpu.serve, driven by
  the port's ``PolicyClient`` over the proxy: a weight push flips the
  deterministic action;
- the port's ``ship_checkpoint`` through ray_tpu's store fetched by JAX's
  ``fetch_checkpoint``, and JAX's shipped one fetched by the port's,
  each byte-equal and verified after its source directory is deleted;
- the port's ``DQN`` beside JAX's for 2 iterations on the corridor (one
  runner of 64 steps an iteration, 4 grad steps from the first), from
  the same weights and runner seed: the replay buffers equal, the
  params and every step's gradient under
  tests/test_torch_rl_offpolicy.py's Adam rule.
"""

import functools
import http.client
import os
import shutil
import sys
import time

import cloudpickle
import jax
import numpy as np
import optax
import pytest
import torch

import ray_tpu
from ray_tpu import serve
from ray_tpu.cluster_utils import Cluster
from ray_tpu.collective import CollectiveActorMixin, create_collective_group
from ray_tpu.rl import dqn as j_dqn
from ray_tpu.rl import learner_group as j_lg
from ray_tpu.rl import rl_module as j_rlm
from ray_tpu.serve.api import Deployment, DeploymentHandle
from ray_tpu.serve.overload import wait_bulk_clearance
from ray_tpu.train import checkpoint as j_ckpt
from ray_tpu_torch.rl import dqn as t_dqn
from ray_tpu_torch.rl import learner_group as t_lg
from ray_tpu_torch.rl import models as t_models
from ray_tpu_torch.rl import policy_server as t_ps
from ray_tpu_torch.rl import rl_module as t_rlm
from ray_tpu_torch.train import checkpoint as t_ckpt
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths
from tests.test_torch_rl import _np
from tests.test_torch_rl_hosted import Corridor
from tests.test_torch_rl_hosted import RayRuntime as _BaseRuntime
from tests.test_torch_rl_offpolicy import _Recording, assert_adam_steps_close


def _ray_allreduce(group_name, vector):
    """A member's allreduce, run inside its actor."""
    from ray_tpu import collective

    return np.asarray(collective.allreduce(
        np.asarray(vector, np.float32), group_name=group_name))


class RayRuntime(_BaseRuntime):
    """``serve.runtime``'s interface over ray_tpu actors, collectives,
    Serve deployments and the object store."""

    def __init__(self):
        self._routes = []

    def spawn(self, cls, kwargs, *, name="", max_concurrency=1):
        # a member may join a collective group: give it ray_tpu's hook
        member = type(cls.__name__, (cls, CollectiveActorMixin), {})
        return super().spawn(member, kwargs, name=name,
                             max_concurrency=max_concurrency)

    def call(self, handle, method, *args, fetch_tags=None, **kwargs):
        if isinstance(handle, DeploymentHandle):
            return handle.method(method).remote(*args, **kwargs)
        return super().call(handle, method, *args, **kwargs)

    def get(self, refs, timeout=None, fetch_tags=None):
        if not fetch_tags:
            return ray_tpu.get(refs, timeout=timeout)
        from ray_tpu._private.worker import fetch_context

        with fetch_context(**fetch_tags):
            return ray_tpu.get(refs, timeout=timeout)

    def put(self, tree, *, owned=False):
        # a store put owns its bytes; _inline=False keeps the copy in the
        # store for third processes, as JAX's ship_checkpoint asks
        return ray_tpu.put(tree, _inline=False) if owned else \
            ray_tpu.put(tree)

    def kill(self, handle):
        if isinstance(handle, DeploymentHandle):
            from ray_tpu.serve.api import _controller

            ray_tpu.get(_controller().delete.remote(handle.name), timeout=60)
            return
        super().kill(handle)

    def collective(self, handles, group_name):
        n = len(handles)
        create_collective_group(handles, n, list(range(n)),
                                group_name=group_name)
        return [functools.partial(_ray_allreduce, group_name)] * n

    def deploy(self, cls, *, name, route_prefix, init_args=(),
               init_kwargs=None, num_replicas=1, max_concurrent_queries):
        dep = Deployment(cls, num_replicas=num_replicas,
                         max_concurrent_queries=max_concurrent_queries,
                         resources={"CPU": 0}, route_prefix=route_prefix)
        handle = serve.run(dep, name=name, init_args=init_args,
                           init_kwargs=init_kwargs)
        self._routes.append(route_prefix)
        return handle

    def http_address(self):
        """The proxy's address, once it routes every route deployed here:
        the proxy answers before its first long-poll of the route table,
        and a POST that arrives first gets a 404."""
        address = serve.start_http_proxy()
        deadline = time.monotonic() + 60
        for route in self._routes:
            while _status(address, route) == 404:
                assert time.monotonic() < deadline, f"{route} not routed"
                time.sleep(0.1)
        return address


def _status(address, route):
    """The status of an empty POST to ``route`` (the deployment answers
    it 500)."""
    conn = http.client.HTTPConnection(*address, timeout=30)
    try:
        conn.request("POST", route, "null",
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"CPU": 6, "memory": 4 * 2**30})
    c.connect()
    # the port's members unpickle this module's callables and env
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    cloudpickle.register_pickle_by_value(sys.modules[Corridor.__module__])
    yield c
    serve.shutdown()
    c.shutdown()


def _fake_batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.randn(n, 4).astype(np.float32),
        "actions": rng.randint(0, 2, n).astype(np.int32),
        "logp": (-np.abs(rng.randn(n))).astype(np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "returns": rng.randn(n).astype(np.float32),
    }


def test_hosted_learner_group_matches_jax_group(cluster):
    batch = _fake_batch(64)
    j = j_lg.LearnerGroup(4, 2, num_learners=2, seed=0)
    t = None
    try:
        w0 = j.get_weights()
        t = t_lg.LearnerGroup(4, 2, num_learners=2, seed=0,
                              runtime=RayRuntime(), device="cpu")
        t.set_weights(_np(w0))
        j.update(dict(batch), minibatches=1, epochs=3)
        t.update(dict(batch), minibatches=1, epochs=3)
        want, got = _np(j.get_weights()), t.get_weights()
        assert tree_paths(got) == tree_paths(want)
        for path, g, w in zip(tree_paths(got), tree_leaves(got),
                              tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=path)
        a, b = ray_tpu.get([m.get_weights.remote() for m in t.learners],
                           timeout=60)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    finally:
        j.shutdown()
        if t is not None:
            t.shutdown()


def test_hosted_policy_server_weight_push(cluster):
    module = t_rlm.DiscretePolicyModule(obs_dim=2, n_actions=2)
    jparams = j_rlm.DiscretePolicyModule(2, 2).init(jax.random.PRNGKey(0))
    params = t_models.from_jax_params(_np(jparams), device="cpu")
    server = t_ps.PolicyServer(module, params, name="port_det_policy",
                               route="/port_det", explore=False,
                               runtime=RayRuntime(), device="cpu")
    client = t_ps.PolicyClient(server.address, route="/port_det")
    obs = np.array([0.3, 1.0], np.float32)

    def served_action():
        eid = client.start_episode()
        a = client.get_action(eid, obs)
        client.end_episode(eid, obs)
        return a

    try:
        base = served_action()
        forced = {k: dict(v) for k, v in params.items()}
        bias = torch.zeros(2)
        bias[1 - base] = 50.0
        forced["pi"]["b"] = bias
        server.set_weights(forced)
        assert served_action() == 1 - base
        batch = server.drain_samples()
        assert batch["actions"].tolist() == [base, 1 - base]
        assert batch["dones"].tolist() == [True, True]
    finally:
        server.shutdown()


def _members(path):
    out = {}
    for fn in sorted(os.listdir(path)):
        with open(os.path.join(path, fn), "rb") as f:
            out[fn] = f.read()
    return out


def test_hosted_checkpoint_shipping_both_ways(cluster, tmp_path):
    rt = RayRuntime()
    g = torch.Generator().manual_seed(1)
    port_src = str(tmp_path / "port" / "ck")
    t_ckpt.save_state({"w": torch.randn(256, 64, generator=g),
                       "b": torch.randn(64, generator=g)}, port_src)
    jax_src = str(tmp_path / "jax" / "ck2")
    j_ckpt.save_state({"v": jax.numpy.arange(40.0).reshape(8, 5)}, jax_src)
    wants = _members(port_src), _members(jax_src)
    # the port ships, JAX fetches
    ref = t_ckpt.ship_checkpoint(port_src, runtime=rt,
                                 wait_clearance=wait_bulk_clearance)
    assert isinstance(ref, ray_tpu.ObjectRef)
    shutil.rmtree(tmp_path / "port")
    got = j_ckpt.fetch_checkpoint(ref, str(tmp_path / "by_jax"))
    assert _members(got.path) == wants[0]
    # JAX ships, the port fetches
    ref = j_ckpt.ship_checkpoint(jax_src)
    shutil.rmtree(tmp_path / "jax")
    got = t_ckpt.fetch_checkpoint(ref, str(tmp_path / "by_port"), runtime=rt)
    assert _members(got.path) == wants[1]
    t_ckpt.verify_checkpoint(got.path)


def test_hosted_dqn_matches_jax(cluster):
    cfg = dict(env_creator=Corridor, obs_dim=2, n_actions=2,
               num_env_runners=1, rollout_steps=64, learning_starts=64,
               grad_steps_per_iteration=4, target_update_period=1,
               epsilon_decay_iterations=2, lr=2e-3, seed=3)
    j = j_dqn.DQN(j_dqn.DQNConfig(**cfg))
    t = None
    try:
        # JAX's update without jit, through an optimizer that keeps each
        # gradient (the same functions, step by step)
        j.opt = _Recording(optax.adam(cfg["lr"]), _np)
        j._update = j._update_fn
        t = t_dqn.DQN(t_dqn.DQNConfig(**cfg), runtime=RayRuntime(),
                      device="cpu")
        t.params = t_models.from_jax_params(_np(j.params), device="cpu")
        t.target_params = t_models.from_jax_params(_np(j.target_params),
                                                   device="cpu")
        t.opt = _Recording(t.opt, lambda g: g)
        t.opt_state = t.opt.init(t.params)
        t._sync_runner_weights()
        for it in range(2):
            mj, mt = j.train(), t.train()
            assert mt["buffer_size"] == mj["buffer_size"] == 64 * (it + 1)
            assert mt["epsilon"] == mj["epsilon"]
            assert mt["episode_return_mean"] == mj["episode_return_mean"]
            for k in ("obs", "actions", "rewards", "dones", "next_obs"):
                np.testing.assert_array_equal(
                    getattr(t.buffer, k)[:len(t.buffer)],
                    getattr(j.buffer, k)[:len(j.buffer)], err_msg=k)
            np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-4)
        assert len(t.opt.grads) == len(j.opt.grads) == 8
        assert_adam_steps_close(t.params, j.params, t.opt.grads,
                                j.opt.grads, lambda path: cfg["lr"])
    finally:
        j.stop()
        if t is not None:
            t.stop()
