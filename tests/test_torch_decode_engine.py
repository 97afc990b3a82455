"""The port's RaggedDecoder against the JAX RaggedDecoder on the CPU.

Five streams of different prompt lengths share two slots with two prompt
buckets, so slots are reused and both buckets prefill. Greedy tokens must
be identical; the first-token logprob (the only real one in a greedy
engine) agrees within f32 atol=1e-5; submit rejects the same requests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_engine as jde
from ray_tpu.models import llama as jl
from ray_tpu_torch.models import decode_engine as tde
from ray_tpu_torch.models import llama as tl

ENGINE = dict(slots=2, max_len=64, chunk_tokens=4, prompt_buckets=(8, 16))
PROMPT_LENS = (5, 12, 8, 3, 16)
MAX_NEW = (9, 6, 11, 4, 7)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(remat=False, max_seq_len=64)
    tcfg = tl.LlamaConfig.tiny(max_seq_len=64)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(1, 250, n).astype(np.int32) for n in PROMPT_LENS]


def _run(eng, prompts):
    sids = [eng.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    eng.drain()
    return [eng.pop_finished(s) for s in sids]


def test_engine_matches_jax_engine(models):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts()
    got = _run(tde.RaggedDecoder(tparams, tcfg, device="cpu", **ENGINE), prompts)
    want = _run(jde.RaggedDecoder(jparams, jcfg, **ENGINE), prompts)
    for g, w, n in zip(got, want, MAX_NEW):
        assert g.done and len(g.tokens) == n
        assert g.tokens == w.tokens
        np.testing.assert_allclose(g.logprobs[0], w.logprobs[0], atol=1e-5)
        assert g.logprobs[0] < 0.0 and g.logprobs[1:] == [0.0] * (n - 1)


def test_engine_matches_greedy_generate(models):
    _, _, tcfg, tparams = models
    prompts = _prompts()
    eng = tde.RaggedDecoder(tparams, tcfg, device="cpu", **ENGINE)
    for s, p, n in zip(_run(eng, prompts), prompts, MAX_NEW):
        ref = tl.greedy_generate(tparams, torch.from_numpy(p[None]), tcfg, n)
        assert s.tokens == ref[0, len(p):].tolist()
    st = eng.stats()
    assert st["active"] == 0 and st["queued"] == 0
    assert st["total_tokens"] == sum(MAX_NEW)


def test_take_tokens_streams_and_purges(models):
    _, _, tcfg, tparams = models
    eng = tde.RaggedDecoder(tparams, tcfg, device="cpu", **ENGINE)
    p = _prompts()[0]
    sid = eng.submit(p, 9)
    got, done = [], False
    while not done:
        eng.pump()
        new, lps, done = eng.take_tokens(sid, with_logprobs=True)
        assert len(new) == len(lps)
        got.extend(new)
    ref = tl.greedy_generate(tparams, torch.from_numpy(p[None]), tcfg, 9)
    assert got == ref[0, len(p):].tolist()
    assert eng.take_tokens(sid) == ([], True)


@pytest.mark.parametrize("bad", [
    dict(prompt_tokens=list(range(1, 18)), max_new=4),      # no bucket fits
    dict(prompt_tokens=[1, 2, 3], max_new=4, top_p=0.0),
    dict(prompt_tokens=[1, 2, 3], max_new=4, top_p=1.5),
])
def test_submit_validation_matches_jax(models, bad):
    jcfg, jparams, tcfg, tparams = models
    with pytest.raises(ValueError) as want:
        jde.RaggedDecoder(jparams, jcfg, **ENGINE).submit(**bad)
    with pytest.raises(ValueError) as got:
        tde.RaggedDecoder(tparams, tcfg, device="cpu", **ENGINE).submit(**bad)
    assert str(got.value) == str(want.value)


def test_no_decode_room_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(ENGINE, max_len=16)
    with pytest.raises(ValueError) as want:
        jde.RaggedDecoder(jparams, jcfg, **kw).submit(list(range(1, 16)), 4)
    with pytest.raises(ValueError) as got:
        tde.RaggedDecoder(tparams, tcfg, device="cpu", **kw).submit(
            list(range(1, 16)), 4)
    assert str(got.value) == str(want.value)


def test_sampled_submit_is_not_silently_greedy(models):
    """A sampled submit samples: its tokens are the JAX engine's sampled
    tokens (near-tie rule, tests/test_torch_sampling.py) and differ from
    the greedy ones."""
    from test_torch_sampling import assert_streams_agree, stream_scores

    jcfg, jparams, tcfg, tparams = models
    prompt = np.array([1, 2, 3], np.int32)
    lane = dict(temperature=0.7, seed=2024)
    runs = []
    for eng in (tde.RaggedDecoder(tparams, tcfg, device="cpu", **ENGINE),
                jde.RaggedDecoder(jparams, jcfg, **ENGINE)):
        sid = eng.submit(prompt, 8, **lane)
        eng.drain()
        s = eng.pop_finished(sid)
        runs.append((s.tokens, s.logprobs))
    got, want = runs
    assert len(got[0]) == 8 and all(lp < 0.0 for lp in got[1])
    assert_streams_agree(got, want, stream_scores(tparams, tcfg, prompt,
                                                  got[0], **lane))
    greedy = tl.greedy_generate(tparams, torch.from_numpy(prompt[None]), tcfg, 8)
    assert got[0] != greedy[0, len(prompt):].tolist()


def test_prefill_drops_out_of_range_slots_and_overwrites_whole_slot(models):
    jcfg, jparams, tcfg, tparams = models
    cache = tde.init_ragged_cache(tcfg, 2, 32, device="cpu")
    cache["k"].fill_(7.0)
    cache["v"].fill_(7.0)
    cur = torch.zeros(2, dtype=torch.int32)
    prompts = np.zeros((2, 8), np.int32)
    prompts[0, :5] = _prompts()[0]
    prompts[1, :3] = [4, 5, 6]
    cache, cur, toks0, logp0 = tde._prefill_batch_into_slots(
        tparams, torch.from_numpy(prompts), np.array([5, 3]),
        np.array([1, 2 + 1024]), cache, cur, tcfg)
    # row 1 carried an out-of-range slot: dropped, slot 0 untouched
    assert torch.all(cache["k"][:, 0] == 7.0)
    assert cache["pos"].tolist() == [0, 5] and int(cur[1]) == int(toks0[0])
    # slot 1 was replaced in full: the rows past the prompt are zero
    assert torch.all(cache["k"][:, 1, 8:] == 0.0)
    # the same prefill through the JAX function gives the same k rows
    jcache = jde.init_ragged_cache(jcfg, 2, 32)
    jcache, _, jt0, jlp0 = jde._prefill_batch_into_slots(
        jparams, jnp.asarray(prompts), jnp.asarray([5, 3], jnp.int32),
        jnp.asarray([1, 2 + 1024], jnp.int32), jnp.zeros(2, jnp.uint32),
        jnp.zeros(2, jnp.float32), jnp.ones(2, jnp.float32), jcache,
        jnp.zeros(2, jnp.int32), jcfg)
    np.testing.assert_allclose(cache["k"][:, 1].numpy(),
                               np.asarray(jcache["k"][:, 1]), atol=1e-5)
    assert toks0.tolist() == np.asarray(jt0).tolist()
    np.testing.assert_allclose(logp0.numpy(), np.asarray(jlp0), atol=1e-5)


def test_pos_clamps_and_inactive_slots_hold_their_token(models):
    _, _, tcfg, tparams = models
    cache = tde.init_ragged_cache(tcfg, 2, 8, device="cpu")
    cache["pos"][:] = torch.tensor([5, 2], dtype=torch.int32)
    tok = torch.tensor([3, 9], dtype=torch.int32)
    active = torch.tensor([True, False])
    toks, cache, last = tde.decode_chunk(tparams, cache, tok, active, tcfg, 4)
    assert cache["pos"].tolist() == [7, 2]  # 5 + 4 clamped at max_len - 1
    assert toks[1].tolist() == [9, 9, 9, 9] and int(last[1]) == 9


def test_engine_with_params_that_require_grad(models):
    """Weights a trainer publishes require grad: the engine and the cached
    forward run without autograd, give the same tokens, and hand out no
    tensor that requires grad."""
    _, _, tcfg, tparams = models
    prompts = _prompts()
    want = [s.tokens for s in _run(tde.RaggedDecoder(tparams, tcfg,
                                                     device="cpu", **ENGINE),
                                   prompts)]
    grad_params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.clone().requires_grad_())
                   for k, v in tparams.items()}
    eng = tde.RaggedDecoder(grad_params, tcfg, device="cpu", **ENGINE)
    assert [s.tokens for s in _run(eng, prompts)] == want
    assert not any(x.requires_grad for x in (eng.cache["k"], eng.cache["v"],
                                             eng.cache["pos"], eng.cur_tok))
    toks = torch.from_numpy(prompts[0][None])
    cache = tl.init_cache(tcfg, 1, 32, device="cpu")
    logits, cache = tl.forward_with_cache(grad_params, toks, tcfg, cache)
    assert not logits.requires_grad and not cache["k"].requires_grad
    out = tl.greedy_generate(grad_params, toks, tcfg, 4)
    assert not out.requires_grad
    assert out[0, len(prompts[0]):].tolist() == want[0][:4]
