"""The port's prefix cache and disaggregated prefill against the JAX package.

Counterparts of tests/test_serve_llm_pool.py:83-163 (the prefix cache's
LRU and matching, warm admission against a cold prefill, prefill_kv +
submit_prefilled against inline admission), each also held against the
JAX engine on the same TINY model (f32, 2 layers). Chain keys must be
byte-equal to JAX's. Tokens follow the near-tie rule of
tests/test_torch_sampling.py (TOKEN_TOL = 1e-4; logprobs within 1e-5 up
to a divergence): a warm admission prefills the suffix alone, so its
products have other shapes than a cold prefill's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_engine as jde
from ray_tpu.models import kv_prefix_cache as jpc
from ray_tpu.models import llama as jl
from ray_tpu_torch.models import decode_engine as tde
from ray_tpu_torch.models import kv_prefix_cache as tpc
from ray_tpu_torch.models import llama as tl
from test_torch_sampling import assert_streams_agree, stream_scores

ENGINE = dict(slots=2, max_len=64, chunk_tokens=3, prompt_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=96,
                          dtype="float32", remat=False)
    tcfg = tl.LlamaConfig.tiny(max_seq_len=96)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(models, port, **kw):
    jcfg, jparams, tcfg, tparams = models
    if port:
        return tde.RaggedDecoder(tparams, tcfg, device="cpu", **{**ENGINE, **kw})
    return jde.RaggedDecoder(jparams, jcfg, **{**ENGINE, **kw})


def _drain_one(eng, sid):
    eng.drain()
    s = eng.pop_finished(sid)
    return np.asarray(s.tokens), np.asarray(s.logprobs, np.float32)


@pytest.mark.parametrize("block", [1, 4, 8, 32])
def test_chain_keys_byte_equal_to_jax(block):
    rng = np.random.RandomState(block)
    for n in (0, 3, 31, 32, 33, 100):
        toks = rng.randint(0, 2**31 - 1, n).astype(np.int32)
        assert tpc.chain_keys(toks, block) == jpc.chain_keys(toks, block)


def test_prefix_cache_lru_and_match():
    """The JAX test's sequence on both caches: same matches, same stats
    (f32 slabs, so the byte counts agree too)."""
    toks = np.arange(1, 17, dtype=np.int32)  # 16 tokens, 4 blocks
    k = np.zeros((2, 12, 2, 8), np.float32)  # rows for 3 blocks
    v = np.ones_like(k)
    caches = (tpc.PrefixCache(block=4, max_bytes=10_000),
              jpc.PrefixCache(block=4, max_bytes=10_000))
    port_k = torch.from_numpy(k)
    assert caches[0].insert(toks, port_k, torch.from_numpy(v)) == 3
    assert caches[1].insert(toks, k, v) == 3
    other = toks.copy()
    other[5] = 99
    for pc in caches:
        n, e = pc.match(toks[:13])
        assert n == 12 and e is not None  # deepest depth, capped at len-1
        n, e = pc.match(toks[:9])
        assert n == 8 and e is not None
        assert pc.match(other)[0] == 4  # a diverging block breaks the chain
    n, e = caches[0].match(toks[:13])
    assert isinstance(e["k"], torch.Tensor) and e["k"].is_contiguous()
    assert e["k"].data_ptr() != port_k.data_ptr()  # its own slab
    assert caches[0].stats() == caches[1].stats()
    # byte-budget eviction is LRU
    smalls = (tpc.PrefixCache(block=4, max_bytes=k[:, :4].nbytes * 2 + 1),
              jpc.PrefixCache(block=4, max_bytes=k[:, :4].nbytes * 2 + 1))
    for pc, conv in zip(smalls, (torch.from_numpy, np.asarray)):
        pc.insert(toks[:5], conv(k[:, :4]), conv(v[:, :4]))
        assert pc.stats()["entries"] == 1
        pc.insert(np.asarray([7] * 5, np.int32), conv(k[:, :4] + 1),
                  conv(v[:, :4]))
        pc.insert(np.asarray([9] * 5, np.int32), conv(k[:, :4] + 2),
                  conv(v[:, :4]))
        st = pc.stats()
        assert st["evictions"] >= 1 and st["bytes"] <= pc.max_bytes
        # the oldest entry went first
        assert pc.match(toks[:5])[1] is None
        assert pc.match(np.asarray([9] * 5, np.int32))[0] == 4
    assert smalls[0].stats() == smalls[1].stats()
    # bf16 slabs, which numpy cannot hold
    pc = tpc.PrefixCache(block=4)
    pc.insert(toks, port_k.to(torch.bfloat16), port_k.to(torch.bfloat16))
    assert pc.match(toks)[1]["k"].dtype == torch.bfloat16
    assert pc.stats()["bytes"] == 2 * 3 * (2 * 4 * 2 * 8) * 2 * 2


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_prefix_cache_warm_equals_cold(models, temperature):
    """A repeated-system-prompt workload: the first prompt prefills cold
    and fills the cache, the rest adopt the cached 16-token head and
    prefill only their tails; each stream's tokens equal a cold engine's
    and the JAX engine's warm path's."""
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(1)
    head = rng.randint(1, 256, size=16).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(1, 256, size=n).astype(np.int32)])
               for n in (4, 6, 3, 7)]
    lane = dict(temperature=temperature, seed=31)
    warm_port = _engine(models, True, prefix_cache=tpc.PrefixCache(block=8))
    warm_jax = _engine(models, False, prefix_cache=jpc.PrefixCache(block=8))
    cold_port = _engine(models, True)
    for p in prompts:
        got = _drain_one(warm_port, warm_port.submit(p, 10, **lane))
        want = _drain_one(warm_jax, warm_jax.submit(p, 10, **lane))
        cold = _drain_one(cold_port, cold_port.submit(p, 10, **lane))
        scores = stream_scores(tparams, tcfg, p, cold[0], **lane)
        assert_streams_agree(got, cold, scores)
        assert_streams_agree(got, want, scores)
    st = warm_port.stats()["prefix_cache"]
    assert st["hits"] == len(prompts) - 1 and st["misses"] == 1
    assert st == warm_jax.stats()["prefix_cache"]
    assert "prefix_cache" not in cold_port.stats()


def test_prefix_cache_unusable_match_and_set_params(models):
    """A match whose suffix bucket would run past the slot prefills cold
    (and counts as a miss); set_params drops the cache, whose rows belong
    to the old weights."""
    rng = np.random.RandomState(2)
    head = rng.randint(1, 256, size=24).astype(np.int32)
    pc = tpc.PrefixCache(block=8)
    eng = _engine(models, True, prefix_cache=pc, prompt_buckets=(8, 48))
    _drain_one(eng, eng.submit(np.concatenate([head, [5, 6, 7]]), 4))
    assert pc.stats()["entries"] == 3  # depths 8, 16 and 24
    long_tail = np.concatenate([head, rng.randint(1, 256, 20).astype(np.int32)])
    # 24 cached rows + a 48-row suffix bucket overrun the 64-row slot
    _drain_one(eng, eng.submit(long_tail, 4))
    assert pc.stats()["hits"] == 0 and pc.stats()["misses"] == 2
    eng.set_params(eng.params, 3)
    assert pc.stats()["entries"] == 0 and eng.weights_version == 3


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_disaggregated_prefill_adopt(models, temperature):
    """prefill_kv (greedy) / prefill_kv_sampled on a 'prefill worker' +
    submit_prefilled on a 'decode engine' continue as an inline admission
    does, with the port's payload (torch tensors) and with the JAX
    worker's (numpy f32); and as the JAX engine adopting JAX's payload."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 256, size=20).astype(np.int32)
    padded = np.zeros((1, 32), np.int32)
    padded[0, :len(prompt)] = prompt
    seed = 77
    lane = dict(temperature=temperature, seed=seed)
    lens = [len(prompt)]
    if temperature:
        k, v, tok0, lp0 = tde.prefill_kv_sampled(
            tparams, torch.from_numpy(padded), lens, [seed], [temperature],
            [1.0], tcfg, 64)
        jk, jv, jt0, jlp0 = jde.prefill_kv_sampled(
            jparams, jnp.asarray(padded), jnp.asarray(lens, jnp.int32),
            jnp.asarray([seed], jnp.uint32),
            jnp.asarray([temperature], jnp.float32),
            jnp.asarray([1.0], jnp.float32), jcfg, 64)
        firsts = ({"first_logprob": float(lp0[0])},
                  {"first_logprob": float(jlp0[0])})
    else:
        k, v, tok0 = tde.prefill_kv(tparams, torch.from_numpy(padded), lens,
                                    tcfg, 64)
        jk, jv, jt0 = jde.prefill_kv(jparams, jnp.asarray(padded),
                                     jnp.asarray(lens, jnp.int32), jcfg, 64)
        firsts = ({}, {})
    assert k.shape == (2, 1, 64, 2, 16) and tok0.dtype == torch.int32
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    assert int(tok0[0]) == int(jt0[0])
    port_kv = {"k": k[:, 0], "v": v[:, 0], "first_token": int(tok0[0]),
               "true_len": len(prompt), **firsts[0]}
    jax_kv = {"k": np.asarray(jk[:, 0]), "v": np.asarray(jv[:, 0]),
              "first_token": int(jt0[0]), "true_len": len(prompt), **firsts[1]}
    inline_eng = _engine(models, True)
    inline = _drain_one(inline_eng, inline_eng.submit(prompt, 10, **lane))
    scores = stream_scores(tparams, tcfg, prompt, inline[0], **lane)
    jeng = _engine(models, False)
    want = _drain_one(jeng, jeng.submit_prefilled(prompt, 10, jax_kv, **lane))
    if not temperature:  # a greedy payload carries no first logprob
        inline = (inline[0], np.concatenate([[0.0], inline[1][1:]]))
    for kv in (port_kv, jax_kv):
        eng = _engine(models, True)
        got = _drain_one(eng, eng.submit_prefilled(prompt, 10, kv, **lane))
        assert_streams_agree(got, inline, scores)
        assert_streams_agree(got, want, scores)
    if not temperature:
        greedy = tl.greedy_generate(tparams, torch.from_numpy(prompt[None]),
                                    tcfg, 10)[0, len(prompt):].numpy()
        assert_streams_agree((got[0], got[1]), (greedy, got[1]), scores)


@pytest.mark.parametrize("bad", [
    dict(rows=32),            # KV rows != max_len
    dict(true_len=19),        # true_len != prompt length
    dict(top_p=0.0),
    dict(max_len_room=True),  # no decode room
])
def test_submit_prefilled_validation_matches_jax(models, bad):
    rng = np.random.RandomState(4)
    n = 63 if bad.get("max_len_room") else 20
    prompt = rng.randint(1, 256, size=n).astype(np.int32)
    rows = bad.get("rows", 64)
    kv = {"k": np.zeros((2, rows, 2, 16), np.float32),
          "v": np.zeros((2, rows, 2, 16), np.float32), "first_token": 3,
          "true_len": bad.get("true_len", n)}
    top_p = bad.get("top_p", 1.0)
    with pytest.raises(ValueError) as want:
        _engine(models, False).submit_prefilled(prompt, 4, kv, top_p=top_p)
    with pytest.raises(ValueError) as got:
        _engine(models, True).submit_prefilled(prompt, 4, kv, top_p=top_p)
    assert str(got.value) == str(want.value)
