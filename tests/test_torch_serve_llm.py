"""The port's LLMServer and PrefillWorker against the JAX package's, on the CPU.

Both packages serve the "tiny" f32 config from one weight tree: the JAX
``build_model`` tree, passed as ``params_blob`` (numpy) to each. Tokens
follow the near-tie rule of tests/test_torch_sampling.py; logprobs and KV
rows agree within atol 1e-5, as in tests/test_torch_decode_engine.py.
Concurrent calls come from handler threads; the servers' pump threads do
every piece of model work.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import llm_pool as jpool
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import hooks
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import llm_pool as tpool
from test_torch_sampling import LOGPROB_TOL, assert_streams_agree, stream_scores

SERVER = dict(slots=4, max_len=64, chunk_tokens=4, prompt_buckets=(8, 16))
SAMPLED = dict(temperature=0.8, top_p=0.95)
JOIN_S = 120


@pytest.fixture(scope="module")
def blob():
    params, _ = jllm.build_model("tiny", max_len=64, seed=0)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tmodel(blob):
    return tllm.build_model("tiny", max_len=64, params_blob=blob, device="cpu")


@pytest.fixture
def server(blob):
    made = []

    def make(port=True, **kw):
        cls = tllm.LLMServer if port else jllm.LLMServer
        extra = {"device": "cpu"} if port else {}
        srv = cls("tiny", params_blob=blob, **{**SERVER, **extra, **kw})
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.shutdown(drain_s=5.0)
    hooks.config_reset()


@pytest.mark.parametrize("size", ["tiny", "tiny-wide", "1b"])
def test_build_model_configs_match_jax(size):
    """The same config per named size; from a JAX blob, the same tree."""
    tcfg = tllm.model_config(size, max_len=48, vocab_size=1000)
    if size == "1b":  # JAX's 1B config, without building its 5 GB tree
        jcfg = jl.LlamaConfig(**{
            **jl.llama2_size("1b").__dict__, "vocab_size": 1000,
            "max_seq_len": 48, "dtype": "bfloat16", "remat": False})
    else:
        jparams, jcfg = jllm.build_model(size, max_len=48, seed=1)
        blob = jax.tree_util.tree_map(np.asarray, jparams)
        tparams, cfg = tllm.build_model(size, max_len=48, params_blob=blob,
                                        device="cpu")
        assert cfg == tcfg
        np.testing.assert_array_equal(tparams["layers"]["wq"].numpy(),
                                      blob["layers"]["wq"])
    for f in dataclasses.fields(tcfg):
        if hasattr(jcfg, f.name):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_build_model_seeded_weights_are_reproducible():
    a, _ = tllm.build_model("tiny", max_len=32, seed=4, device="cpu")
    b, _ = tllm.build_model("tiny", max_len=32, seed=4, device="cpu")
    c, _ = tllm.build_model("tiny", max_len=32, seed=5, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("layers", [0, 1, 7])
def test_build_spec_draft_matches_jax(layers):
    """The same draft depth (0: half the stack; clamped to the stack) and
    an identity head of the same shapes (its w1 is drawn by another
    generator)."""
    _, jcfg = jllm.build_model("tiny", max_len=32)
    tcfg = tllm.model_config("tiny", max_len=32, vocab_size=256)
    jn, jhead = jllm.build_spec_draft(jcfg, draft_layers=layers,
                                      draft_head=True, seed=2)
    tn, thead = tllm.build_spec_draft(tcfg, draft_layers=layers,
                                      draft_head=True, seed=2, device="cpu")
    assert tn == jn
    for k in ("w1", "b1", "w2"):
        assert tuple(thead[k].shape) == jhead[k].shape
    assert not thead["w2"].any() and not thead["b1"].any()
    assert tllm.build_spec_draft(tcfg, draft_layers=layers)[1] is None


def _prompts(n, seed=3, lens=(5, 7, 12, 3, 16, 9)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 250, lens[i % len(lens)]).tolist() for i in range(n)]


def _concurrently(fns):
    """Run each fn on its own handler thread; their results in order."""
    out = [None] * len(fns)
    errs = []

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


def _check_stamps(out, n):
    stamps = out["token_times_s"]
    assert len(out["tokens"]) == n and len(stamps) == n
    assert out["submitted_s"] <= stamps[0]
    assert all(b >= a for a, b in zip(stamps, stamps[1:]))


@pytest.mark.parametrize("lane", ["greedy", "sampled"])
def test_concurrent_generate_matches_jax_server(server, tmodel, lane):
    """Six concurrent generate() calls on 4 slots: tokens and logprobs
    equal the JAX server's on the same requests."""
    tparams, tcfg = tmodel
    prompts = _prompts(6)
    lanes = [dict(SAMPLED, seed=50 + i) if lane == "sampled" else {}
             for i in range(6)]
    n = 10
    results = {}
    for port in (True, False):
        srv = server(port)
        results[port] = _concurrently([
            (lambda p=p, ln=ln: srv.generate(p, n, **ln))
            for p, ln in zip(prompts, lanes)])
    for p, ln, got, want in zip(prompts, lanes, results[True],
                                results[False]):
        _check_stamps(got, n)
        assert got["weights_version"] == want["weights_version"] == 0
        assert_streams_agree(
            (got["tokens"], got["logprobs"]), (want["tokens"], want["logprobs"]),
            stream_scores(tparams, tcfg, np.asarray(p, np.int32), got["tokens"],
                          **ln))


def test_stream_tokens_equal_generate(server):
    """submit_stream + polling delivers generate()'s tokens and logprobs,
    in pieces, with the weight version; a done stream is released."""
    srv = server()
    p = _prompts(1)[0]
    want = srv.generate(p, 12, **SAMPLED, seed=9)
    sid = srv.submit_stream({"prompt_ids": p, "max_tokens": 12,
                             **SAMPLED, "seed": 9})["sid"]
    toks, lps, deadline = [], [], time.monotonic() + JOIN_S
    while True:
        r = srv.poll_stream(sid)
        toks += r["tokens"]
        lps += r["logprobs"]
        assert r["version"] in (None, 0)
        if r["done"]:
            break
        assert time.monotonic() < deadline
        time.sleep(0.002)
    assert toks == want["tokens"]
    np.testing.assert_allclose(lps, want["logprobs"], atol=LOGPROB_TOL)
    assert srv.poll_stream(sid) == {"tokens": [], "logprobs": [], "done": True,
                                    "version": None}


def test_poll_streams_costs_one_rpc_per_tick(server):
    srv = server()
    prompts = _prompts(5)
    sids = [srv.submit_stream({"prompt_ids": p, "max_tokens": 6})["sid"]
            for p in prompts]
    got = {sid: [] for sid in sids}
    live, deadline = set(sids), time.monotonic() + JOIN_S
    while live:
        before = srv.stats()["stream_polls"]
        out = srv.poll_streams(sorted(live))
        assert srv.stats()["stream_polls"] == before + 1
        assert set(out) == live
        for sid, r in out.items():
            got[sid] += r["tokens"]
            if r["done"]:
                live.discard(sid)
        assert time.monotonic() < deadline
        time.sleep(0.002)
    for sid, p in zip(sids, prompts):
        assert got[sid] == srv.generate(p, 6)["tokens"]


@pytest.mark.parametrize("lane", ["greedy", "sampled"])
def test_prefill_worker_matches_jax_and_adopts_as_inline(server, blob, lane):
    """The port's PrefillWorker payload equals JAX's (KV rows, first token
    and logprob, length, version); adopt_prefilled continues exactly as an
    inline generate() of the same request."""
    ln = dict(SAMPLED, seed=77) if lane == "sampled" else {}
    p = _prompts(1, seed=8)[0]
    kw = dict(max_len=64, prompt_buckets=(8, 16), params_blob=blob)
    got = tpool.PrefillWorker("tiny", device="cpu", **kw).prefill(p, **ln)
    want = jpool.PrefillWorker("tiny", **kw).prefill(p, **ln)
    assert set(got) == set(want)
    for key in ("k", "v"):
        assert tuple(got[key].shape) == want[key].shape == (2, 64, 2, 16)
        np.testing.assert_allclose(np.asarray(got[key]), want[key], atol=1e-5)
    assert got["first_token"] == want["first_token"]
    np.testing.assert_allclose(got["first_logprob"], want["first_logprob"],
                               atol=LOGPROB_TOL)
    assert (got["true_len"], got["version"]) == (want["true_len"],
                                                 want["version"]) == (len(p), 0)
    srv = server()
    adopted = srv.adopt_prefilled(got, p, 10, **ln)
    inline = srv.generate(p, 10, **ln)
    assert adopted["tokens"] == inline["tokens"]
    np.testing.assert_allclose(adopted["logprobs"], inline["logprobs"],
                               atol=LOGPROB_TOL)
    _check_stamps(adopted, 10)


def test_prefill_worker_update_weights_matches_jax(blob):
    scaled = {**blob, "lm_head": blob["lm_head"] * 3.0}
    kw = dict(max_len=64, prompt_buckets=(8, 16), params_blob=blob)
    port = tpool.PrefillWorker("tiny", device="cpu", **kw)
    ref = jpool.PrefillWorker("tiny", **kw)
    assert port.update_weights(scaled, 3) == ref.update_weights(scaled, 3) == 3
    p = _prompts(1, seed=9)[0]
    got, want = port.prefill(p), ref.prefill(p)
    assert got["version"] == want["version"] == 3
    assert got["first_token"] == want["first_token"]
    np.testing.assert_allclose(got["first_logprob"], want["first_logprob"],
                               atol=LOGPROB_TOL)
    assert port.health() and ref.health()


def test_update_weights_versions_later_streams_and_clears_prefix_cache(
        server, blob):
    srv = server(prefix_cache_block=4)
    long_prompt = _prompts(1, lens=(13,))[0]
    before = srv.generate(long_prompt, 6)
    assert before["weights_version"] == 0
    assert srv.stats()["prefix_cache"]["entries"] > 0
    # a different network: the same tree with the lm head scaled
    scaled = {**blob, "lm_head": blob["lm_head"] * 3.0}
    assert srv.update_weights(scaled, 1) == 1
    deadline = time.monotonic() + JOIN_S  # the swap lands at a chunk boundary
    while srv.weights_version() != 1:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    short = srv.generate([5, 6, 7], 6)  # too short to enter the cache
    assert short["weights_version"] == 1 and srv.weights_version() == 1
    assert srv.stats()["prefix_cache"]["entries"] == 0
    after = srv.generate(long_prompt, 6)
    assert after["weights_version"] == 1
    ref = tllm.LLMServer("tiny", params_blob=scaled, device="cpu", **SERVER)
    try:
        assert after["tokens"] == ref.generate(long_prompt, 6)["tokens"]
    finally:
        assert ref.shutdown(drain_s=5.0)


def test_apply_config_sets_spec_depth_of_next_pump(server, tmodel):
    """serve_spec_enabled False runs plain pumps; serve_spec_depth
    overrides the constructor's depth; greedy tokens stay the same."""
    srv = server(spec_depth=2, spec_draft_layers=1)
    p = _prompts(1, seed=4)[0]

    def run():
        before = srv.stats()["spec"]
        out = srv.generate(p, 12)
        after = srv.stats()["spec"]
        return (out["tokens"], after["pumps"] - before["pumps"],
                after["proposed"] - before["proposed"])

    base, pumps, proposed = run()
    assert pumps > 0 and proposed % 2 == 0 and proposed > 0
    assert srv.apply_config({"serve_spec_enabled": False}) == {
        "serve_spec_enabled": False}
    plain, pumps, _ = run()
    assert pumps == 0
    assert srv.apply_config({"serve_spec_enabled": True,
                             "serve_spec_depth": 3})["serve_spec_depth"] == 3
    deep, pumps, proposed = run()
    assert pumps > 0 and proposed % 3 == 0 and proposed > 0
    tparams, tcfg = tmodel
    scores = stream_scores(tparams, tcfg, np.asarray(p, np.int32), base)
    for toks in (plain, deep):
        assert_streams_agree((toks, [0.0] * 12), (base, [0.0] * 12), scores)
    with pytest.raises(KeyError):
        srv.apply_config({"no_such_flag": 1})


def test_shutdown_drains_then_rejects(server):
    srv = server()
    p = _prompts(1)[0]
    out = _concurrently([lambda: srv.generate(p, 12),
                         lambda: srv.shutdown(drain_s=30.0)])
    assert len(out[0]["tokens"]) == 12 and out[1] is True
    assert not srv._pump_thread.is_alive() and not srv.health()
    with pytest.raises(RuntimeError, match="draining"):
        srv.generate(p, 4)
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit_stream({"prompt_ids": p})


@pytest.mark.parametrize("inference_mode", [True, False])
def test_server_serves_inside_and_outside_inference_mode(server, tmodel,
                                                         inference_mode):
    """The pump thread enters inference mode itself, so a cache made
    inside the mode (by a caller in it) is written by the pump, and one
    made outside it too; tokens equal greedy_generate's."""
    tparams, tcfg = tmodel
    p = _prompts(1, seed=5)[0]
    with torch.inference_mode(inference_mode):
        srv = server()
        out = srv.generate(p, 8)
    ref = tl.greedy_generate(tparams, torch.tensor([p]), tcfg, 8)
    assert out["tokens"] == ref[0, len(p):].tolist()


def test_bad_requests_raise_in_the_handler(server):
    srv = server()
    with pytest.raises(ValueError, match="bucket"):
        srv.generate(list(range(1, 30)), 4)
    with pytest.raises(ValueError, match="top_p"):
        srv.generate([1, 2, 3], 4, temperature=1.0, top_p=0.0)
    assert srv.generate([1, 2, 3], 4)["tokens"]  # the pump lives on
