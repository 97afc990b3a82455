"""The ray_tpu runtime hosts the port's LLMPool over its own actors.

The port's pool takes its calls on members from a runtime value; here it
is built from ``ray_tpu.remote``, ``get``, ``put``, ``kill`` and
``RayActorError``, so each decode replica is the port's ``LLMServer``
(on the CPU) as a ray_tpu actor, the published weights ride the object
store, and a kill is a real actor death. The runtime's config, fault
injection, flight recorder, trace context, overload guardian and error
classes come in through ``serve.hooks.Hooks``.
"""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu._private import config as _cfg
from ray_tpu._private import fault_injection as _fi
from ray_tpu._private import flight_recorder as _fr
from ray_tpu._private import trace as _trace
from ray_tpu.cluster_utils import Cluster
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import overload as joverload
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import hooks
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import llm_pool as tpool

JOIN_S = 120


class RayRuntime:
    """``serve.runtime``'s interface over ray_tpu actors."""

    actor_error = ray_tpu.RayActorError

    def spawn(self, cls, kwargs, *, name="", max_concurrency=1):
        return ray_tpu.remote(num_cpus=0)(cls).options(
            max_concurrency=max_concurrency).remote(**kwargs)

    def call(self, handle, method, *args, fetch_tags=None, **kwargs):
        m = getattr(handle, method)
        if fetch_tags:
            m = m.options(fetch_tags=fetch_tags)
        return m.remote(*args, **kwargs)

    def get(self, refs, timeout=None):
        return ray_tpu.get(refs, timeout=timeout)

    def put(self, tree):
        return ray_tpu.put(tree)

    def is_ref(self, x):
        return isinstance(x, ray_tpu.ObjectRef)

    def kill(self, handle):
        ray_tpu.kill(handle)

    def is_initialized(self):
        return ray_tpu.is_initialized()


# the hooks go to the replicas' worker processes: each field is a ray_tpu
# name (pickled by reference) or a lambda (pickled by value)
HOSTED = hooks.Hooks(
    config_get=_cfg.get, config_set=_cfg.set_system_config, fire=_fi.fire,
    record=_fr.record,
    # a weight blob passed to a constructor arrives as its ObjectRef
    resolve=lambda blob: (ray_tpu.get(blob, timeout=600)
                          if isinstance(blob, ray_tpu.ObjectRef) else blob),
    trace=types.SimpleNamespace(
        root_scope=_trace.root_scope, scope=_trace.scope,
        current=_trace.current, new_trace_id=_trace.new_trace_id,
        new_span_id=_trace.new_span_id),
    guardian=joverload.OverloadGuardian,
    overloaded_error=joverload.PoolOverloadedError,
    deadline_error=joverload.DeadlineExceededError)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"CPU": 4, "memory": 4 * 2**30})
    c.connect()
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def blob():
    params, _ = jllm.build_model("tiny", max_len=96, seed=0)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def pool(cluster):
    made = []

    def make(**kw):
        p = tpool.LLMPool("tiny", **{
            "slots": 2, "max_len": 96, "chunk_tokens": 2,
            "prompt_buckets": (8,), "autoscale": False, "device": "cpu",
            "hooks": HOSTED, "runtime": RayRuntime(), **kw})
        made.append(p)
        return p

    yield make
    for p in made:
        p.shutdown()
    _cfg.set_system_config({"serve_spec_enabled": True,
                            "overload_escalate_dwell_s": 1.0,
                            "overload_recover_dwell_s": 3.0})


def _greedy(params, cfg, prompt, n):
    return tl.greedy_generate(params, torch.tensor([prompt]), cfg,
                              n)[0, len(prompt):].tolist()


def test_hosted_pool_replica_kill_no_client_visible_error(pool, blob):
    """Weights published through the object store, then a replica killed
    mid-stream and another with generate() calls in flight: every client
    gets its whole greedy continuation on those weights."""
    p = pool(min_replicas=3, max_replicas=3, chunk_delay_s=0.02)
    assert isinstance(p._guardian, joverload.OverloadGuardian)
    assert p.publish_weights(blob) == 1 and p.wait_version(1, timeout=JOIN_S)
    params, cfg = tllm.build_model("tiny", max_len=96, params_blob=blob,
                                   device="cpu")
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 250, 6).tolist()
    rid = p.submit_stream({"prompt_ids": prompt, "max_tokens": 40})["rid"]
    toks, killed, deadline = [], False, time.monotonic() + JOIN_S
    while True:
        out = p.poll_stream(rid)
        toks += out["tokens"]
        assert out["weights_version"] == 1
        if len(toks) >= 6 and not killed:
            ray_tpu.kill(p._streams[rid]["rep"].handle)
            killed = True
        if out["done"]:
            break
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert killed and toks == _greedy(params, cfg, prompt, 40)

    prompts = [rng.randint(1, 250, 6).tolist() for _ in range(4)]
    outs = [None] * 4

    def one(i):
        outs[i] = p.generate(prompts[i], 30)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    time.sleep(0.3)
    ray_tpu.kill(p._alive()[0].handle)
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    for q, out in zip(prompts, outs):
        assert out is not None, "a client saw an error"
        assert out["tokens"] == _greedy(params, cfg, q, 30)
    assert len(p._alive()) == 1


def test_guardian_shed_speculation_reaches_port_replicas(pool):
    """ray_tpu's OverloadGuardian, wired in through the guardian hook,
    walks to L1 and PoolActions.shed_speculation switches speculation off
    in every replica's own process (apply_config); recovery to L0 turns it
    back on. Greedy tokens stay the same throughout."""
    p = pool(min_replicas=2, max_replicas=2, chunk_tokens=4,
             spec_depth=2, spec_draft_layers=1)
    g = p._guardian
    _cfg.set_system_config({"overload_escalate_dwell_s": 0.0,
                            "overload_recover_dwell_s": 0.0})
    prompts = [[3, 5, 7, 9, 11, 13], [2, 4, 6, 8, 10, 12]]

    def run():
        before = {k: v["spec"]["pumps"]
                  for k, v in p.stats()["per_replica"].items()}
        outs = [None, None]

        def one(i):
            outs[i] = p.generate(prompts[i], 12)["tokens"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(JOIN_S)
        after = p.stats()["per_replica"]
        return outs, sum(after[k]["spec"]["pumps"] - before[k] for k in before)

    spec, pumps = run()
    assert pumps > 0
    assert g.tick({"queue_per_replica": 100.0}) == 1
    assert not _cfg.get("serve_spec_enabled")
    plain, pumps = run()
    assert pumps == 0 and plain == spec
    assert g.tick({"queue_per_replica": 0.0}) == 0
    assert _cfg.get("serve_spec_enabled")
    again, pumps = run()
    assert pumps > 0 and again == spec
    assert p.stats()["overload"]["transitions"] == 2
