"""The ray_tpu runtime hosts the port's serving wrappers as user code.

The port imports nothing of the runtime; here the runtime's own config,
fault injection, flight recorder, metrics, network pacer, byte accounting
and object-store get are wired into ``ray_tpu_torch.serve.hooks.Hooks``,
and the port's LLMServer runs under them: in-process, and as a ray_tpu
Serve deployment answering concurrent requests (the counterpart of
tests/test_serve_llm.py::test_llm_deployment_concurrent_requests).
"""

import functools
import logging
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import serve
from ray_tpu._private import config as _cfg
from ray_tpu._private import fault_injection as _fi
from ray_tpu._private import flight_recorder as _fr
from ray_tpu._private import net_accounting as _net
from ray_tpu._private import net_qos as _qos
from ray_tpu.cluster_utils import Cluster
from ray_tpu.serve.api import Deployment
from ray_tpu.util import metrics as M
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import hooks
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import llm_pool as tpool
from test_torch_sampling import assert_streams_agree, stream_scores

SERVER = dict(slots=4, max_len=64, chunk_tokens=4, prompt_buckets=(8, 16),
              device="cpu")
SAMPLED = dict(temperature=0.8, top_p=0.95)


@functools.cache
def _runtime_metrics():
    return hooks.metric_families(M.Gauge, M.Counter, M.Histogram)


def _kv_pace(peer, nbytes, owner):
    try:
        _qos.acquire(peer, "kv", nbytes, owner=owner, timeout=5.0)
    except _qos.NetPaceError:
        pass  # a typed park: the handoff proceeds (the bytes arrived)


def _kv_account(direction, peer, owner, nbytes, tenant="-"):
    account = _net.account_rx if direction == "rx" else _net.account_tx
    account(peer, "kv", owner, nbytes, tenant=tenant)


def _resolve(blob):
    if isinstance(blob, ray_tpu.ObjectRef):
        from ray_tpu._private.worker import fetch_context

        with fetch_context(qos="bulk", owner="weights"):
            return ray_tpu.get(blob, timeout=600)
    return blob


RUNTIME = hooks.Hooks(
    config_get=_cfg.get, config_set=_cfg.set_system_config, fire=_fi.fire,
    record=_fr.record, metrics=_runtime_metrics, kv_pace=_kv_pace,
    kv_account=_kv_account, resolve=_resolve)


@pytest.fixture
def server():
    made = []

    def make(**kw):
        srv = tllm.LLMServer("tiny", hooks=RUNTIME, **{**SERVER, **kw})
        made.append(srv)
        return srv

    yield make
    _fi.clear()
    _cfg.set_system_config({"serve_spec_enabled": True,
                            "serve_spec_depth": 0})
    for srv in made:
        srv.shutdown(drain_s=5.0)


def _prompts(n, seed=21):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 250, 4 + 2 * i).tolist() for i in range(n)]


def _generate_all(srv, prompts, lanes, n):
    out = [None] * len(prompts)

    def run(i):
        out[i] = srv.generate(prompts[i], n, **lanes[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_spec_verify_drop_gives_the_same_tokens(server):
    """A fault plan that drops every serve.spec_verify pump runs plain
    pumps (no verify) and emits the tokens of the speculative run; so does
    speculation switched off through the runtime's config."""
    srv = server(spec_depth=2, spec_draft_layers=1)
    params, cfg = srv.engine.params, srv.cfg
    prompts = _prompts(4)
    lanes = [{}, {}, dict(SAMPLED, seed=1), dict(SAMPLED, seed=2)]

    def run():
        before = srv.stats()["spec"]["pumps"]
        out = _generate_all(srv, prompts, lanes, 12)
        return out, srv.stats()["spec"]["pumps"] - before

    spec, spec_pumps = run()
    assert spec_pumps > 0
    _fi.configure({"site": "serve.spec_verify", "action": "drop",
                   "count": 0})
    dropped, pumps = run()
    assert pumps == 0
    assert {h["site"] for h in _fi.hits()} == {"serve.spec_verify"}
    _fi.clear()
    assert srv.apply_config({"serve_spec_enabled": False}) == {
        "serve_spec_enabled": False}
    off, pumps = run()
    assert pumps == 0
    for p, ln, a, b, c in zip(prompts, lanes, spec, dropped, off):
        scores = stream_scores(params, cfg, np.asarray(p, np.int32),
                               a["tokens"], **ln)
        for got in (b, c):
            assert_streams_agree((got["tokens"], got["logprobs"]),
                                 (a["tokens"], a["logprobs"]), scores)


def test_pump_survives_a_raising_replica_pump_site(server, caplog):
    srv = server()
    p = _prompts(1)[0]
    want = srv.generate(p, 8)["tokens"]
    _fi.clear()  # an empty hit log: the loop below waits for this plan's
    with caplog.at_level(logging.ERROR, logger="ray_tpu_torch"):
        _fi.configure({"site": "serve.replica_pump", "action": "die",
                       "match": {"engine": srv.engine.name}, "count": 1})
        deadline = time.monotonic() + 60
        while not _fi.hits():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert srv.generate(p, 8)["tokens"] == want
    assert srv.health() and srv._pump_thread.is_alive()
    errors = [r for r in caplog.records if r.getMessage() == "decode pump error"]
    assert len(errors) == 1 and errors[0].exc_info[0] is _fi.InjectedFault


def _spans(name, since_mono):
    """The recorder's `name` spans that started after `since_mono` (the
    ring is bounded, so an index into it would not do)."""
    since = _fr.wall(since_mono)
    return [s for s in list(_fr._get().ring)
            if s["name"] == name and s["start_s"] >= since]


def test_spans_and_metrics_land_in_the_runtime(server):
    """serve.first_token / serve.decode per stream, serve.spec_verify per
    speculative pump, serve.prefill and serve.kv_handoff for a
    disaggregated stream, the TBT histogram, gauges and spec counters,
    all in the runtime's recorder and metrics; the KV bytes in its
    accounting."""
    srv = server(spec_depth=2, spec_draft_layers=1, engine_name="hosted-1")
    since = time.monotonic()
    rx_before = _net.total("rx", owner="hosted-1")
    p = _prompts(1)[0]
    out = srv.generate(p, 10)
    worker = tpool.PrefillWorker("tiny", max_len=64, prompt_buckets=(8, 16),
                                 device="cpu", hooks=RUNTIME,
                                 name="prefill-hosted")
    kv = worker.prefill(p)
    adopted = srv.adopt_prefilled(kv, p, 10)
    assert adopted["tokens"] == out["tokens"]
    first = _spans("serve.first_token", since)
    assert [s["attrs"]["engine"] for s in first] == ["hosted-1"] * 2
    for s, o in zip(first, (out, adopted)):
        assert s["end_s"] - s["start_s"] == pytest.approx(
            o["token_times_s"][0] - o["submitted_s"], abs=1e-3)
    decode = _spans("serve.decode", since)
    assert [s["attrs"]["tokens"] for s in decode] == [10, 10]
    assert _spans("serve.spec_verify", since)
    (prefill,) = _spans("serve.prefill", since)
    (handoff,) = _spans("serve.kv_handoff", since)
    nb = int(kv["k"].nbytes + kv["v"].nbytes)
    assert prefill["attrs"]["kv_bytes"] == handoff["attrs"]["kv_bytes"] == nb
    assert _net.total("rx", owner="hosted-1") - rx_before == nb
    for family in ("tbt", "tps", "active", "spec_proposed"):
        series = _runtime_metrics()[family]._values
        assert any(("engine", "hosted-1") in k for k in series), family


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"CPU": 4, "memory": 4 * 2**30})
    c.connect()
    yield c
    serve.shutdown()
    c.shutdown()


def test_port_server_as_a_serve_deployment(cluster):
    """The port's LLMServer, deployed as a ray_tpu Serve replica on the
    CPU with the runtime's config, chaos and recorder hooks: concurrent
    requests share its slot batch and each returns its exact greedy
    continuation with its stamps."""
    dep = Deployment(tllm.LLMServer, max_concurrent_queries=8,
                     resources={"CPU": 0}, route_prefix="/llm-torch")
    handle = serve.run(dep, name="llm-torch", init_kwargs={
        "model_size": "tiny", "slots": 2, "max_len": 96, "chunk_tokens": 4,
        "prompt_buckets": (8, 16), "device": "cpu",
        "hooks": hooks.Hooks(config_get=_cfg.get,
                             config_set=_cfg.set_system_config,
                             fire=_fi.fire, record=_fr.record)})
    params, cfg = tllm.build_model("tiny", max_len=96, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, size=7).astype(np.int32) for _ in range(5)]
    max_new = 8
    refs = [handle.remote({"prompt_ids": p.tolist(), "max_tokens": max_new})
            for p in prompts]
    outs = ray_tpu.get(refs, timeout=180)
    for p, out in zip(prompts, outs):
        want = tl.greedy_generate(params, torch.from_numpy(p[None]).long(),
                                  cfg, max_new)[0, len(p):].tolist()
        assert out["tokens"] == want
        assert len(out["token_times_s"]) == max_new
        assert out["token_times_s"][0] >= out["submitted_s"]
