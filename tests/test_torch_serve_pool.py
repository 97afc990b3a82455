"""The port's LLMPool against the JAX package, on the CPU.

Every pool here runs the "tiny" f32 config with its members in this
process (``serve.runtime.InProcessRuntime``, the default). The JAX
package's weights go in through ``publish_weights`` with the numpy tree
of ``ray_tpu.serve.llm.build_model``, which each replica adopts in the
port's layout (``llama.from_jax_params``); the tokens are held against a
plain JAX ``RaggedDecoder`` on the same weights under the near-tie rule
of tests/test_torch_sampling.py, and logprobs within its LOGPROB_TOL.
Concurrent clients are threads, as a hosting runtime's handlers are.
"""

import contextlib
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_engine as jde
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import overload as joverload
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import hooks
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import llm_pool as tpool
from ray_tpu_torch.serve import overload as toverload
from test_torch_sampling import (LOGPROB_TOL, assert_streams_agree,
                                 assert_tokens_agree, stream_scores)

MAX_LEN = 96
SAMPLED = dict(temperature=0.8, top_p=0.95)
JOIN_S = 120


def _jax_blob(seed):
    params, _ = jllm.build_model("tiny", max_len=MAX_LEN, seed=seed)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def blob():
    return _jax_blob(0)


@pytest.fixture(scope="module")
def tmodel(blob):
    return tllm.build_model("tiny", max_len=MAX_LEN, params_blob=blob,
                            device="cpu")


def jax_streams(blob, prompts, n, lanes):
    """(tokens, logprobs) of each request on a plain JAX engine."""
    jparams, jcfg = jllm.build_model("tiny", max_len=MAX_LEN, params_blob=blob)
    eng = jde.RaggedDecoder(jparams, jcfg, slots=2, max_len=MAX_LEN,
                            chunk_tokens=4, prompt_buckets=(8, 16))
    sids = [eng.submit(np.asarray(p, np.int32), n, **ln)
            for p, ln in zip(prompts, lanes)]
    eng.drain()
    out = []
    for sid in sids:
        s = eng.pop_finished(sid)
        out.append((list(s.tokens[:n]), list(s.logprobs[:n])))
    return out


def check_against_jax(tmodel, blob, prompts, got, n, lanes):
    """Each (tokens, logprobs) against the JAX engine's. A greedy stream's
    logprobs are 0.0 in an engine that has served no sampled stream yet
    and real after, in both packages, so they depend on what else each
    engine served: only a sampled stream's logprobs are compared."""
    tparams, tcfg = tmodel
    for p, ln, g, w in zip(prompts, lanes, got,
                           jax_streams(blob, prompts, n, lanes)):
        scores = stream_scores(tparams, tcfg, np.asarray(p, np.int32), g[0],
                               **ln)
        if ln.get("temperature", 0.0) > 0.0:
            assert_streams_agree(g, w, scores)
        else:
            assert_tokens_agree(g[0], w[0], scores)


@pytest.fixture
def pool(blob):
    """Pool factory: the JAX weights published as version 1 and adopted by
    every replica before the pool is handed out."""
    made = []

    def make(publish=True, **kw):
        p = tpool.LLMPool("tiny", **{
            "slots": 2, "max_len": MAX_LEN, "chunk_tokens": 4,
            "prompt_buckets": (8, 16), "min_replicas": 2, "max_replicas": 2,
            "autoscale": False, "device": "cpu", **kw})
        made.append(p)
        if publish:
            assert p.publish_weights(blob) == 1
            assert p.wait_version(1, timeout=JOIN_S)
        return p

    yield make
    for p in made:
        p.shutdown()
    hooks.config_reset()


def _prompts(n, seed=3, lens=(5, 7, 12, 3, 14, 9)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 250, lens[i % len(lens)]).tolist() for i in range(n)]


def drain_stream(pool, rid, on_tokens=None):
    """Poll until done: (tokens, logprobs, the last poll's reply)."""
    toks, lps, deadline = [], [], time.monotonic() + JOIN_S
    while True:
        out = pool.poll_stream(rid)
        toks += out["tokens"]
        lps += out["logprobs"]
        if on_tokens is not None:
            on_tokens(len(toks))
        if out["done"]:
            return toks, lps, out
        assert time.monotonic() < deadline, "stream did not finish"
        time.sleep(0.005)


def wait_until(cond, what):
    deadline = time.monotonic() + JOIN_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def concurrently(fns):
    out, errs = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    if errs:
        raise errs[0]
    return out


def _stream_request(pool, p, n, ln, on_tokens=None):
    rid = pool.submit_stream({"prompt_ids": p, "max_tokens": n, **ln})["rid"]
    toks, lps, last = drain_stream(pool, rid, on_tokens)
    return (toks, lps), last


@pytest.mark.parametrize("lane", ["greedy", "sampled"])
def test_generate_and_streams_match_jax(pool, tmodel, blob, lane):
    """Six concurrent requests over two replicas, half generate(), half
    streamed: each equals the JAX engine's stream on the same weights and
    carries the published version; both replicas served."""
    p = pool()
    prompts = _prompts(6)
    lanes = [dict(SAMPLED, seed=40 + i) if lane == "sampled" else {}
             for i in range(6)]
    n = 10

    def one(i):
        if i % 2 == 0:
            out = p.generate(prompts[i], n, **lanes[i])
            assert out["weights_version"] == 1
            return out["tokens"], out["logprobs"]
        got, last = _stream_request(p, prompts[i], n, lanes[i])
        assert last["weights_version"] == 1
        return got

    got = concurrently([lambda i=i: one(i) for i in range(6)])
    check_against_jax(tmodel, blob, prompts, got, n, lanes)
    st = p.stats()
    assert st["replicas"] == 2 and st["weights_version"] == 1
    assert all(s["total_tokens"] > 0 for s in st["per_replica"].values())
    assert st["inflight"] == 0 and st["ttft_p99_s"] is not None


def test_replica_kill_mid_stream_and_mid_generate_no_client_error(
        pool, tmodel, blob):
    """The counterpart of test_serve_llm_pool.py's chaos test: kill a
    replica mid-stream, then another with generate() calls in flight; the
    pool re-queues onto survivors and every client gets its whole greedy
    continuation, never an error."""
    p = pool(min_replicas=3, max_replicas=3, chunk_tokens=2,
             chunk_delay_s=0.02)
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 250, 6).tolist()
    rid = p.submit_stream({"prompt_ids": prompt, "max_tokens": 40})["rid"]
    killed = []

    def kill_at_six(n):
        if n >= 6 and not killed:
            victim = p._streams[rid]["rep"]
            server = victim.handle.obj
            p.runtime.kill(victim.handle)
            killed.append(server)

    toks, lps, _ = drain_stream(p, rid, kill_at_six)
    assert killed and len(p._alive()) == 2
    # the killed replica's pump ended and let its engine go
    killed[0]._pump_thread.join(10)
    assert not killed[0]._pump_thread.is_alive() and killed[0].engine is None

    prompts = [rng.randint(1, 250, 6).tolist() for _ in range(4)]
    calls = [lambda q=q: p.generate(q, 30) for q in prompts]

    def kill_one():
        time.sleep(0.3)
        p.runtime.kill(p._alive()[0].handle)

    outs = concurrently(calls + [kill_one])[:4]
    assert len(p._alive()) == 1
    for q, got, n in [(prompt, (toks, lps), 40)] + [
            (q, (o["tokens"], o["logprobs"]), 30)
            for q, o in zip(prompts, outs)]:
        check_against_jax(tmodel, blob, [q], [got], n, [{}])


def test_sampled_spec_failover_exact_against_plain_jax_engine(
        pool, tmodel, blob):
    """A sampled stream on speculating replicas, its replica killed
    mid-stream: the replayed stream reproduces a plain (non-speculative)
    JAX engine's sampled stream for the same (prompt, seed)."""
    p = pool(chunk_tokens=2, chunk_delay_s=0.02, spec_depth=4,
             spec_draft_layers=1)
    prompt = np.random.RandomState(7).randint(1, 250, 6).tolist()
    lane = dict(temperature=0.8, seed=12345)
    killed = []

    def kill_at_six(n):
        if n >= 6 and not killed:
            killed.append(p._streams[rid]["rep"].name)
            p.runtime.kill(p._streams[rid]["rep"].handle)

    rid = p.submit_stream({"prompt_ids": prompt, "max_tokens": 32,
                           **lane})["rid"]
    got = drain_stream(p, rid, kill_at_six)[:2]
    assert killed
    check_against_jax(tmodel, blob, [prompt], [got], 32, [lane])
    specs = [s.get("spec") for s in p.stats()["per_replica"].values()]
    assert any(sp and sp["pumps"] > 0 for sp in specs)


def test_splice_guard_truncates_after_a_publish(pool, blob):
    """A stream whose replica dies after tokens went out AND after new
    weights were published closes at its emitted prefix (truncated)
    rather than splice a continuation of another policy onto it."""
    p = pool(chunk_tokens=2, chunk_delay_s=0.02)
    prompt = np.random.RandomState(9).randint(1, 250, 7).tolist()
    rid = p.submit_stream({"prompt_ids": prompt, "max_tokens": 40})["rid"]
    toks = []
    deadline = time.monotonic() + JOIN_S
    while len(toks) < 4:
        out = p.poll_stream(rid)
        toks += out["tokens"]
        assert not out["done"] and time.monotonic() < deadline
        time.sleep(0.005)
    scaled = {**blob, "lm_head": blob["lm_head"] * 3.0}
    assert p.publish_weights(scaled) == 2
    p.runtime.kill(p._streams[rid]["rep"].handle)
    rest, _, last = drain_stream(p, rid)
    assert last == {"tokens": [], "logprobs": [], "done": True,
                    "truncated": True, "weights_version": 1}
    assert rid not in p._streams and len(toks + rest) < 40
    (want, _), = jax_streams(blob, [prompt], 40, [{}])
    assert toks == want[:len(toks)]
    # a stream admitted after the publish runs whole under version 2
    (got, lps), last = _stream_request(p, prompt, 8, {})
    assert last["weights_version"] == 2
    (want2, _), = jax_streams(scaled, [prompt], 8, [{}])
    assert got == want2


def test_multiplex_routes_by_model_id_with_lru_residency(pool, blob):
    """register_model + model_id routes a request to that model's weights
    (held against JAX on them); "" is the construction model; the hook's
    model id routes a request that names none; the LRU keeps
    max_resident_models; an unregistered id raises."""
    current = {"id": ""}
    p = pool(min_replicas=1, max_replicas=1, max_resident_models=2,
             hooks=hooks.Hooks(model_id=lambda: current["id"]))
    alts = {name: _jax_blob(s) for name, s in (("alt", 42), ("alt2", 7),
                                                ("alt3", 11))}
    for name, tree in alts.items():
        p.register_model(name, tree)
    prompt = np.random.RandomState(8).randint(1, 250, 6).tolist()

    def greedy_of(tree):
        return jax_streams(tree, [prompt], 12, [{}])[0][0]

    assert p.generate(prompt, 12)["tokens"] == greedy_of(blob)
    assert p.generate(prompt, 12, model_id="alt")["tokens"] == greedy_of(
        alts["alt"])
    base, cfg = tllm.build_model("tiny", max_len=MAX_LEN, seed=0, device="cpu")
    want = tl.greedy_generate(base, torch.tensor([prompt]), cfg, 12)
    assert p.generate(prompt, 12, model_id="")["tokens"] == want[
        0, len(prompt):].tolist()
    current["id"] = "alt2"
    assert p.generate(prompt, 12)["tokens"] == greedy_of(alts["alt2"])
    assert p.generate(prompt, 12, model_id="alt")["tokens"] == greedy_of(
        alts["alt"])
    current["id"] = "alt3"
    out = p.submit_stream({"prompt_ids": prompt, "max_tokens": 12})
    assert drain_stream(p, out["rid"])[0] == greedy_of(alts["alt3"])
    st = p.stats()
    assert st["active_model"] == "alt3"
    assert st["registered_models"] == ["alt", "alt2", "alt3"]
    assert st["resident_models"] == ["alt", "alt3"]  # alt2 evicted
    with pytest.raises(KeyError):
        p.generate(prompt, 4, model_id="nope")
    with pytest.raises(ValueError):
        p.register_model("", blob)


def test_autoscale_up_and_drain_down(pool, tmodel, blob):
    """Queue pressure scales the pool to max_replicas; idleness drains it
    back to min_replicas, the retired replica's pump joined."""
    p = pool(slots=1, chunk_tokens=2, min_replicas=1, max_replicas=2,
             target_queue_per_replica=1.0, autoscale=True,
             chunk_delay_s=0.05)
    p.AUTOSCALE_PERIOD_S = 0.2
    servers = {}
    prompts = [np.random.RandomState(7 + i).randint(1, 250, 6).tolist()
               for i in range(6)]
    peak = []

    def watch():
        deadline = time.monotonic() + 60
        while len(p._alive()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        peak.append(len(p._alive()))
        servers.update({r.name: r.handle.obj for r in p._alive()})

    outs = concurrently([lambda q=q: p.generate(q, 30) for q in prompts]
                        + [watch])[:6]
    assert peak == [2], "pool never scaled up"
    for q, o in zip(prompts, outs):
        check_against_jax(tmodel, blob, [q], [(o["tokens"], o["logprobs"])],
                          30, [{}])
    deadline = time.monotonic() + 90
    while len(p._replicas) > 1:
        assert time.monotonic() < deadline, "pool never drained down"
        time.sleep(0.1)
    (retired,) = set(servers) - {p._replicas[0].name}
    servers[retired]._pump_thread.join(10)
    assert not servers[retired]._pump_thread.is_alive()


def test_prefill_threshold_routing_bit_equal_to_inline(pool, tmodel, blob):
    """Prompts at or over prefill_threshold go through the PrefillWorker
    (by generate() and by stream) and equal their inline runs on the same
    replica token for token (sampled logprobs within LOGPROB_TOL: the
    worker prefills at width 1, the replica at its slot width); shorter ones
    prefill inline; all match JAX."""
    p = pool(prefill_workers=1, prefill_threshold=12)
    prompts = _prompts(4, seed=11, lens=(14, 7, 16, 12))
    lanes = [{}, {}, dict(SAMPLED, seed=5), dict(SAMPLED, seed=6)]
    n = 10
    routed0 = p._prefill_rr
    got = [None] * 4
    for i in range(4):
        if i % 2 == 0:
            out = p.generate(prompts[i], n, **lanes[i])
            got[i] = (out["tokens"], out["logprobs"])
        else:
            got[i] = _stream_request(p, prompts[i], n, lanes[i])[0]
    assert p._prefill_rr - routed0 == 3  # lengths 14, 16 and 12
    rt, rep = p.runtime, p._replicas[0]
    for prompt, ln, g in zip(prompts, lanes, got):
        inline = rt.get(rt.call(rep.handle, "generate", prompt, n, **ln))
        assert g[0] == inline["tokens"]
        if ln:  # a greedy stream's logprobs are 0.0 until the engine
            # has served a sampled one, so only sampled ones compare
            np.testing.assert_allclose(g[1], inline["logprobs"],
                                       atol=LOGPROB_TOL)
    check_against_jax(tmodel, blob, prompts, got, n, lanes)


def test_deadline_fast_fail_and_typed_errors(pool):
    """A request that expires in the queue is reaped, one whose predicted
    wait exceeds its deadline fails at once; both typed, retryable, no
    slot spent. A hosting runtime's own error classes come through the
    hooks."""
    p = pool(min_replicas=1, max_replicas=1, slots=1, chunk_tokens=2,
             max_inflight_per_replica=1, chunk_delay_s=0.05,
             hooks=hooks.Hooks(deadline_error=joverload.DeadlineExceededError))
    prompt = [3, 5, 7, 9, 11]
    bg = threading.Thread(target=lambda: p.generate(prompt, 20))
    bg.start()
    wait_until(lambda: p._replicas[0].inflight, "the first admission")
    t0 = time.monotonic()
    with pytest.raises(joverload.DeadlineExceededError) as e:
        p.generate(prompt, 4, deadline_s=0.2, tenant="gold")
    assert 0.2 <= time.monotonic() - t0 < 5
    assert (e.value.reason, e.value.tenant, e.value.retryable) == (
        "deadline_expired", "gold", True)
    bg.join(JOIN_S)
    p.generate(prompt, 2)  # a third admission: the pool now has a rate
    waiters = [threading.Thread(target=lambda: p.generate(prompt, 20))
               for _ in range(3)]
    for w in waiters:
        w.start()
    wait_until(lambda: p._waiting >= 2, "two queued requests")
    t0 = time.monotonic()
    with pytest.raises(joverload.PoolOverloadedError) as e:
        p.generate(prompt, 4, deadline_s=0.001)
    assert time.monotonic() - t0 < 1.0
    assert type(e.value) is joverload.DeadlineExceededError
    assert e.value.reason == "deadline" and e.value.retry_after_s > 0.001
    for w in waiters:
        w.join(JOIN_S)
    assert p._replicas[0].inflight == 0 and p._waiting == 0


def test_l3_shed_is_typed_and_a_drop_plan_admits(pool):
    """At guardian level L3 a request over the queue bound is shed with
    the port's PoolOverloadedError (retryable, retry-after hint), counted
    in the shed metric; a fault plan that drops the shed admits it."""
    shed_counts = []
    counter = types.SimpleNamespace(
        inc=lambda value=1.0, tags=None: shed_counts.append(tags))
    fams = dict(hooks.INERT.metrics(), shed=counter)
    guardian = types.SimpleNamespace(level=toverload.L3_SHED_ADMISSION,
                                     tick=lambda: None, state=lambda: {})
    plan = {"fire": None}
    p = pool(min_replicas=1, max_replicas=1, slots=1, chunk_tokens=2,
             max_inflight_per_replica=1, chunk_delay_s=0.05,
             hooks=hooks.Hooks(guardian=lambda pool: guardian,
                               metrics=lambda: fams,
                               fire=lambda site, **ctx: plan["fire"]))
    hooks.config_set({"overload_shed_queue_bound": 1})
    prompt = [3, 5, 7, 9, 11]
    bg = threading.Thread(target=lambda: p.generate(prompt, 20))
    bg.start()
    wait_until(lambda: p._replicas[0].inflight, "the first admission")
    waiter = threading.Thread(target=lambda: p.generate(prompt, 4))
    waiter.start()  # 1 waiting + 1 new > the bound of 1
    wait_until(lambda: p._waiting >= 1, "a queued request")
    with pytest.raises(toverload.PoolOverloadedError) as e:
        p.generate(prompt, 4, tenant="bronze")
    assert type(e.value) is toverload.PoolOverloadedError
    assert (e.value.reason, e.value.level, e.value.retryable) == (
        "queue_bound", 3, True)
    assert e.value.retry_after_s >= 0.5
    assert shed_counts == [{"tenant": "bronze", "reason": "queue_bound"}]
    plan["fire"] = "drop"
    assert len(p.generate(prompt, 4)["tokens"]) == 4
    bg.join(JOIN_S)
    waiter.join(JOIN_S)
    assert not bg.is_alive() and not waiter.is_alive()


def test_spans_trace_and_publish_accounting_reach_the_hooks(pool, blob):
    """serve.admission_wait per admission and serve.stream_poll per poll
    that delivers tokens, a stream's polls under the trace it got at
    submit; a publish claims a bulk-class grant for the tree's bytes and
    accounts them."""
    spans, scopes, paced, accounted = [], [], [], []
    ids = iter(range(100))
    trace = types.SimpleNamespace(
        root_scope=contextlib.nullcontext,
        scope=lambda tid, span: scopes.append((tid, span))
        or contextlib.nullcontext(),
        current=lambda: None, new_trace_id=lambda: f"trace-{next(ids)}",
        new_span_id=lambda: "root")

    def record(kind, name, start, end, *, attrs=None, trace=None,
               flush=True):
        assert kind == "serve" and start <= end
        spans.append((name, attrs, trace))

    p = pool(hooks=hooks.Hooks(
        record=record, trace=trace,
        bulk_pace=lambda peer, n, owner: paced.append((peer, n, owner)),
        bulk_account=lambda d, peer, owner, n, tenant="-": accounted.append(
            (d, peer, owner, n))))
    nbytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(blob))
    assert paced == [("serve-pool", nbytes, "weights")]
    assert accounted == [("tx", "serve-pool", "weights", nbytes)]
    prompt = [3, 5, 7, 9, 11]
    p.generate(prompt, 6, tenant="gold")
    got, _ = _stream_request(p, prompt, 9, {"tenant": "gold"})
    waits = [a for name, a, _ in spans if name == "serve.admission_wait"]
    assert len(waits) == 2 and {a["tenant"] for a in waits} == {"gold"}
    assert {a["replica"] for a in waits} <= {"decode-1", "decode-2"}
    polls = [(a, t) for name, a, t in spans if name == "serve.stream_poll"]
    assert sum(a["tokens"] for a, _ in polls) == len(got[0]) == 9
    assert polls[-1][0]["done"] and not any(a["done"] for a, _ in polls[:-1])
    assert {tuple(t.values()) for _, t in polls} == {("trace-0", "root")}
    assert set(scopes) == {("trace-0", "root")}


def test_shutdown_ends_every_pump_and_kills_every_member(pool):
    p = pool(publish=False, prefill_workers=1)
    members = [r.handle for r in p._replicas] + list(p._prefill)
    servers = [h.obj for h in members[:2]]
    assert p.shutdown() and not p.health()
    for srv in servers:
        assert not srv._pump_thread.is_alive()
    assert p._replicas == [] and p._prefill == []
    for h in members:
        with pytest.raises(p.runtime.actor_error):
            p.runtime.get(p.runtime.call(h, "health"), timeout=5)
