"""The port's LLMPool and actor-learner loop with their members in
processes of their own (``serve.process_runtime.ProcessRuntime``), on
the CPU.

One runtime and one pool of two "tiny" f32 replicas serve the module;
each replica is a spawned process that adopts the pool's put of its
weights from the runtime's file store. As in tests/test_torch_serve_pool.py,
the JAX package's weights go in through ``publish_weights`` with the
numpy tree of ``ray_tpu.serve.llm.build_model``, and the tokens are held
against a plain JAX ``RaggedDecoder`` on the same weights under the
near-tie rule of tests/test_torch_sampling.py. Held here:

- the pool's greedy and sampled requests, by generate() and streamed,
  equal JAX's; no replica process has loaded jaxlib;
- ``publish_weights`` then ``wait_version`` reaches every replica
  process, and what they serve then is JAX's on the new weights; five
  publishes leave two puts in the store (the pool's first weights and
  the newest);
- when one of the replicas a pool builds at once fails to spawn, the
  ones built are killed and its error is raised;
- a replica process killed mid-stream (SIGKILL) leaves no client-visible
  error and the same tokens, after JAX's tests/test_serve_llm_pool.py
  chaos test; this runs last, since it leaves the pool one replica;
- a replica on the card raises in its process without one, and the
  error reaches the caller: nothing falls back to the CPU;
- one ActorLearnerLoop iteration over the runtime (its pool replica and
  its ExperienceBuffer processes) holds the checks of
  tests/test_torch_rl_actor_learner.py's in-process loop: conservation,
  exact delivery and the mean ratio at lag 0.
"""

import os
import time

import numpy as np
import pytest

from ray_tpu_torch.rl import actor_learner as t_al
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import llm_pool as tpool
from ray_tpu_torch.serve.process_runtime import ProcessRuntime
from ray_tpu_torch.serve.runtime import InProcessRuntime
from test_torch_serve_pool import (JOIN_S, MAX_LEN, SAMPLED, _jax_blob,
                                   _prompts, _stream_request,
                                   check_against_jax, concurrently,
                                   drain_stream, jax_streams)


@pytest.fixture(scope="module")
def blob():
    return _jax_blob(0)


@pytest.fixture(scope="module")
def tmodel(blob):
    return tllm.build_model("tiny", max_len=MAX_LEN, params_blob=blob,
                            device="cpu")


@pytest.fixture(scope="module")
def rt():
    runtime = ProcessRuntime()
    yield runtime
    runtime.shutdown()


@pytest.fixture(scope="module")
def pool(rt, blob):
    p = tpool.LLMPool("tiny", slots=2, max_len=MAX_LEN, chunk_tokens=2,
                      prompt_buckets=(8, 16), min_replicas=2,
                      max_replicas=2, autoscale=False, chunk_delay_s=0.01,
                      device="cpu", runtime=rt)
    assert p.publish_weights(blob) == 1
    assert p.wait_version(1, timeout=JOIN_S)
    yield p
    p.shutdown()


def _versions(pool):
    rt = pool.runtime
    return [rt.get(rt.call(r.handle, "weights_version"), timeout=JOIN_S)
            for r in pool._alive()]


def test_process_pool_serves_jax_tokens(pool, tmodel, blob):
    pids = {r.handle.pid for r in pool._alive()}
    assert len(pids) == 2 and os.getpid() not in pids
    for pid in pids:
        with open(f"/proc/{pid}/maps") as f:
            assert "jaxlib" not in f.read()
    prompts = _prompts(6)
    lanes = [dict(SAMPLED, seed=40 + i) if i % 3 == 2 else {}
             for i in range(6)]
    n = 10

    def one(i):
        if i % 2 == 0:
            out = pool.generate(prompts[i], n, **lanes[i])
            assert out["weights_version"] == 1
            return out["tokens"], out["logprobs"]
        got, last = _stream_request(pool, prompts[i], n, lanes[i])
        assert last["weights_version"] == 1
        return got

    got = concurrently([lambda i=i: one(i) for i in range(6)])
    check_against_jax(tmodel, blob, prompts, got, n, lanes)
    st = pool.stats()
    assert st["replicas"] == 2 and st["inflight"] == 0
    assert all(s["total_tokens"] > 0 for s in st["per_replica"].values())


def test_publish_reaches_every_replica_process(pool, blob):
    scaled = {**blob, "lm_head": blob["lm_head"] * 3.0}
    prompt = np.random.RandomState(9).randint(1, 250, 7).tolist()
    v = pool.publish_weights(scaled)
    assert pool.wait_version(v, timeout=JOIN_S)
    assert _versions(pool) == [v, v]
    (got, _), last = _stream_request(pool, prompt, 8, {})
    assert last["weights_version"] == v
    assert got == jax_streams(scaled, [prompt], 8, [{}])[0][0]
    v = pool.publish_weights(blob)  # back to the module's weights
    assert pool.wait_version(v, timeout=JOIN_S) and _versions(pool) == [v, v]


def test_publishes_free_the_puts_they_replace(pool, blob):
    store = os.path.dirname(pool._params_ref.path)
    for _ in range(5):
        v = pool.publish_weights(blob)
        assert pool.wait_version(v, timeout=JOIN_S)
    deadline = time.monotonic() + 10  # members hand refs back on a thread
    while len(os.listdir(store)) > 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sorted(os.listdir(store)) == sorted(
        os.path.basename(r.path) for r in (pool._base_ref, pool._params_ref))


class _SecondSpawnFails(InProcessRuntime):
    """Refuses to build decode-2; records the members built and killed."""

    def __init__(self):
        super().__init__()
        self.built, self.killed = [], []

    def spawn(self, cls, kwargs, *, name="", max_concurrency=1):
        if name == "decode-2":
            raise RuntimeError("no room for decode-2")
        handle = super().spawn(cls, kwargs, name=name,
                               max_concurrency=max_concurrency)
        self.built.append(handle)
        return handle

    def kill(self, handle):
        self.killed.append(handle)
        super().kill(handle)


def test_a_failed_replica_spawn_kills_the_replicas_built():
    rt = _SecondSpawnFails()
    with pytest.raises(RuntimeError, match="no room for decode-2"):
        tpool.LLMPool("tiny", slots=2, max_len=MAX_LEN, chunk_tokens=2,
                      prompt_buckets=(8,), min_replicas=3, max_replicas=3,
                      autoscale=False, device="cpu", runtime=rt)
    assert sorted(h.name for h in rt.built) == ["decode-1", "decode-3"]
    assert {id(h) for h in rt.killed} == {id(h) for h in rt.built}


def test_a_replica_on_the_card_raises_in_its_process_without_one(rt):
    with pytest.raises(RuntimeError, match="no CUDA device") as info:
        rt.spawn(tllm.LLMServer, {"model_size": "tiny"}, name="on-card")
    assert "resolve_device" in str(info.value.__cause__)


def test_replica_process_killed_mid_stream_no_client_error(
        pool, tmodel, blob):
    """Runs last: it leaves the pool one replica."""
    version = pool._weights_version
    prompt = np.random.RandomState(5).randint(1, 250, 6).tolist()
    rid = pool.submit_stream({"prompt_ids": prompt, "max_tokens": 40})["rid"]
    killed = []

    def kill_at_six(n):
        if n >= 6 and not killed:
            victim = pool._streams[rid]["rep"].handle
            pool.runtime.kill(victim)
            killed.append(victim)

    toks, lps, last = drain_stream(pool, rid, kill_at_six)
    assert killed and killed[0].process.exitcode is not None
    assert len(pool._alive()) == 1 and last["weights_version"] == version
    check_against_jax(tmodel, blob, [prompt], [(toks, lps)], 40, [{}])


def test_actor_learner_iteration_over_processes(rt):
    loop = t_al.ActorLearnerLoop(
        t_al.ActorLearnerConfig(
            prompt_len=8, max_new=8, iterations=1, trajectories_per_iter=4,
            n_rollout_actors=1, num_learners=1, lr=4.0, publish_every=1,
            base_seed=1, sync_mode=True),
        pool_kwargs=dict(slots=4, chunk_tokens=4, min_replicas=1,
                         max_replicas=1, autoscale=False),
        runtime=rt, device="cpu")
    try:
        members = [loop.buffer] + [r.handle for r in loop.pool._alive()]
        assert os.getpid() not in {m.pid for m in members}
        out = loop.run()
        adopted = loop.pool.wait_version(1, timeout=JOIN_S)
    finally:
        loop.shutdown()
    assert all(m.process.exitcode is not None for m in members)
    assert out["error"] is None, out["error"]
    assert out["resumes"] == {"inplace": 0, "gang": 0}
    assert out["publishes"] == 1 and out["final_version"] == 1 and adopted
    st = out["buffer"]
    assert st["added"] == st["queued"] + st["consumed"] \
        + st["dropped_stale"], st
    assert len(set(st["consumed_seqs"])) == st["consumed"] == 4, st
    assert out["rollouts"]["trajectories"] == st["added"] \
        + st["rejected_stale"] + st["dups"]
    (m,) = out["result"].metrics_history
    assert abs(m["mean_ratio"] - 1.0) < 1e-4, m
    assert m["logp_gap_max"] < 1e-4 and m["tokens"] == 4 * 8
    assert [p["version"] for p in out["publish_timing"]] == [1]
    assert out["rollout_by_version"][0]["tokens"] == 32
