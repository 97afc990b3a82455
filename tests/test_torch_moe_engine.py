"""The port's engine, server and trainer on the mixture-of-experts Llama.

``moe-tiny`` (4 experts, top-2) in f32 through the port's RaggedDecoder
and the JAX RaggedDecoder from one weight tree, in every mode: greedy,
sampled, speculative (depth 4, one draft layer), the prefix cache, and
disaggregated prefill (``prefill_kv`` + ``submit_prefilled``); then the
port's ``LLMServer("moe-tiny")`` and eight train steps.

Capacity routing is per batch row and sizes each expert's buffer from
the row's length, so a token's output depends on the row it is routed
in: its bucket's right padding (pad tokens take expert slots too), the
verify width depth + 1, a suffix-only prefill. That is the JAX package's
semantics, and the port reproduces it: each engine path of the port is
held to the SAME path of the JAX engine, and
``test_capacity_routing_makes_the_engine_differ_from_greedy_generate``
fixes the reference behaviour in both packages. Tokens follow the
near-tie rule of tests/test_torch_sampling.py (TOKEN_TOL = 1e-4,
logprobs within 1e-5 up to a divergence).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_engine as jde
from ray_tpu.models import kv_prefix_cache as jpc
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import decode_engine as tde
from ray_tpu_torch.models import kv_prefix_cache as tpc
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import llm as tllm
from test_torch_sampling import assert_streams_agree, assert_tokens_agree, stream_scores

ENGINE = dict(slots=4, max_len=64, chunk_tokens=8, prompt_buckets=(16, 32))
NEW = 24
SAMPLED = dict(temperature=0.8, top_p=0.95)


@pytest.fixture(scope="module", params=["capacity", "dense"])
def models(request):
    jcfg = jl.LlamaConfig(**{**jl.llama2_size("moe-tiny").__dict__,
                             "dtype": "float32", "remat": False,
                             "max_seq_len": 64, "moe_impl": request.param})
    tcfg = tl.LlamaConfig(**jcfg.__dict__)
    jparams = jax.jit(jl.init_params, static_argnums=0)(
        dataclasses.replace(jcfg, moe_impl="capacity"), jax.random.PRNGKey(0))
    tparams = tl.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(n=6, seed=11, lens=(24, 9, 21, 9, 24, 21)):
    """n prompts of 9 to 24 tokens (three lengths: JAX compiles
    greedy_generate's prefill once per length)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, t).astype(np.int32) for t in lens[:n]]


def _engine(models, port, **kw):
    jcfg, jparams, tcfg, tparams = models
    if port:
        return tde.RaggedDecoder(tparams, tcfg, device="cpu", **{**ENGINE, **kw})
    return jde.RaggedDecoder(jparams, jcfg, **{**ENGINE, **kw})


def _serve(eng, prompts, lanes, n=NEW):
    sids = [eng.submit(p, n, **lane) for p, lane in zip(prompts, lanes)]
    eng.drain()
    out = []
    for sid in sids:
        s = eng.pop_finished(sid)
        out.append((np.asarray(s.tokens), np.asarray(s.logprobs, np.float32)))
    return out


def _lanes(prompts, sampled):
    return [dict(SAMPLED, seed=100 + i) if sampled else {}
            for i in range(len(prompts))]


def _agree(models, prompts, got, want, lanes):
    _, _, tcfg, tparams = models
    for p, g, w, lane in zip(prompts, got, want, lanes):
        assert len(g[0]) == len(w[0]) == NEW
        assert_streams_agree(g, w, stream_scores(tparams, tcfg, p, g[0],
                                                 **lane))


@pytest.fixture(scope="module")
def greedy_runs(models):
    """_prompts() served greedily by each package's engine."""
    prompts = _prompts()
    lanes = _lanes(prompts, False)
    return {"port": _serve(_engine(models, True), prompts, lanes),
            "jax": _serve(_engine(models, False), prompts, lanes)}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_engine_matches_jax_engine(models, greedy_runs, sampled):
    prompts = _prompts()
    lanes = _lanes(prompts, sampled)
    if sampled:
        got = _serve(_engine(models, True), prompts, lanes)
        want = _serve(_engine(models, False), prompts, lanes)
    else:
        got, want = greedy_runs["port"], greedy_runs["jax"]
    _agree(models, prompts, got, want, lanes)


def test_spec_engine_matches_jax_spec_engine(models):
    """Depth 4, one draft layer; greedy and sampled streams share slots."""
    prompts = _prompts(seed=12)
    lanes = [dict(SAMPLED, seed=7 + i) if i % 2 else {}
             for i in range(len(prompts))]
    spec = dict(spec_depth=4, spec_draft_layers=1)
    port = _engine(models, True, **spec)
    got = _serve(port, prompts, lanes)
    want = _serve(_engine(models, False, **spec), prompts, lanes)
    _agree(models, prompts, got, want, lanes)
    assert port.stats()["spec"]["pumps"] > 0


def test_prefix_cache_engine_matches_jax_engine(models):
    """A shared 16-token head: the first stream fills the cache, the rest
    adopt it and prefill their tails alone, in both engines."""
    rng = np.random.RandomState(13)
    head = rng.randint(1, 500, 16).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(1, 500, n).astype(np.int32)])
               for n in (5, 9, 3, 12)]
    lanes = _lanes(prompts, True)
    port = _engine(models, True, prefix_cache=tpc.PrefixCache(block=8))
    jeng = _engine(models, False, prefix_cache=jpc.PrefixCache(block=8))
    # one at a time, so each later admission finds the head cached
    got = [_serve(port, [p], [lane])[0] for p, lane in zip(prompts, lanes)]
    want = [_serve(jeng, [p], [lane])[0] for p, lane in zip(prompts, lanes)]
    _agree(models, prompts, got, want, lanes)
    st = port.stats()["prefix_cache"]
    assert st["hits"] == len(prompts) - 1
    assert st == jeng.stats()["prefix_cache"]


def test_disaggregated_prefill_matches_jax(models):
    """prefill_kv of right-padded prompts in both packages (same KV rows),
    each engine adopting its own package's rows by submit_prefilled."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(n=4, seed=14)
    padded = np.zeros((len(prompts), 32), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lens = [len(p) for p in prompts]
    k, v, tok0 = tde.prefill_kv(tparams, torch.from_numpy(padded), lens, tcfg,
                                ENGINE["max_len"])
    jk, jv, jt0 = jde.prefill_kv(jparams, jnp.asarray(padded),
                                 jnp.asarray(lens, jnp.int32), jcfg,
                                 ENGINE["max_len"])
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(tok0.numpy(), np.asarray(jt0))
    port, jeng = _engine(models, True), _engine(models, False)
    got, want = [], []
    for i, p in enumerate(prompts):
        kv = {"k": k[:, i], "v": v[:, i], "first_token": int(tok0[i]),
              "true_len": len(p)}
        jkv = {"k": np.asarray(jk[:, i]), "v": np.asarray(jv[:, i]),
               "first_token": int(jt0[i]), "true_len": len(p)}
        got.append(port.submit_prefilled(p, NEW, kv))
        want.append(jeng.submit_prefilled(p, NEW, jkv))
    port.drain()
    jeng.drain()
    lanes = [{}] * len(prompts)
    _agree(models, prompts,
           [(np.asarray(port.pop_finished(s).tokens), np.zeros(NEW))
            for s in got],
           [(np.asarray(jeng.pop_finished(s).tokens), np.zeros(NEW))
            for s in want], lanes)


def test_capacity_routing_makes_the_engine_differ_from_greedy_generate(
        models, greedy_runs):
    """The reference behaviour, in both packages: the engine routes each
    admission in its right-padded bucket, greedy_generate the bare
    prompt. Under capacity routing some streams differ (the same ones in
    both packages); under dense dispatch none does."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts()
    differ = {}
    for name, streams in greedy_runs.items():
        differ[name] = []
        for i, (p, (toks, _)) in enumerate(zip(prompts, streams)):
            if name == "port":
                ref = tl.greedy_generate(tparams, torch.from_numpy(p[None]),
                                         tcfg, NEW)[0, len(p):].numpy()
            else:
                ref = np.asarray(jl.greedy_generate(
                    jparams, jnp.asarray(p[None]), jcfg, NEW))[0, len(p):]
            if jcfg.moe_impl == "dense":
                assert_tokens_agree(toks, ref,
                                    stream_scores(tparams, tcfg, p, toks))
            elif not np.array_equal(toks, ref):
                differ[name].append(i)
    assert differ["port"] == differ["jax"]
    if jcfg.moe_impl == "capacity":
        assert differ["port"], "capacity routing changed no stream"


def test_moe_tiny_server_matches_the_engine():
    """build_model("moe-tiny") takes a JAX blob (the same config and tree
    as JAX's build_model); one LLMServer request equals a bare engine's
    tokens on those weights."""
    jparams, jcfg = jllm.build_model("moe-tiny", max_len=64, seed=0)
    blob = jax.tree_util.tree_map(np.asarray, jparams)
    tparams, tcfg = tllm.build_model("moe-tiny", max_len=64, params_blob=blob,
                                     device="cpu")
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.n_experts == 4 and tcfg.dtype == "bfloat16"
    np.testing.assert_array_equal(tparams["layers"]["w_down"].float().numpy(),
                                  blob["layers"]["w_down"].astype(
                                      jnp.bfloat16).astype(np.float32))
    prompt = _prompts(n=1, seed=15)[0]
    kw = dict(slots=2, max_len=64, chunk_tokens=8, prompt_buckets=(32,))
    srv = tllm.LLMServer("moe-tiny", params_blob=blob, device="cpu", **kw)
    try:
        out = srv.generate(prompt.tolist(), 12)
    finally:
        srv.shutdown(drain_s=5.0)
    eng = tde.RaggedDecoder(tparams, tcfg, device="cpu", **kw)
    (want, _), = _serve(eng, [prompt], [{}], n=12)
    assert out["tokens"] == want.tolist()
