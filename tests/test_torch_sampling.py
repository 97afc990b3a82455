"""The port's sampling lanes against the JAX package's, on the CPU.

`_sample_from_logits` over a grid of temperatures and top-p values, then
the port's counterparts of tests/test_decode_sampling.py, each of which
also holds the port's engine against the JAX engine on the same TINY
model (f32, 2 layers).

Tolerances. torch and XLA round log-softmax, cumsum and the Gumbel
noise's logs differently in the last bit or two, so a token can differ
where two candidates are within that of each other. Tokens are held to
the near-tie rule of `assert_tokens_agree`: the sequences are equal, or
at their first difference the two chosen tokens' scores (logits for a
greedy row, filtered logits plus Gumbel noise for a sampled row) are
within TOKEN_TOL = 1e-4 of the best score. Logprobs agree within
LOGPROB_TOL = 1e-5 up to that point; the teacher-forced check keeps
test_decode_sampling.py's 1e-4.
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

TOKEN_TOL = 1e-4
LOGPROB_TOL = 1e-5
ENGINE = dict(max_len=64, chunk_tokens=4, prompt_buckets=(8, 16))


def assert_tokens_agree(got, want, scores, tol=TOKEN_TOL):
    """The near-tie rule. `got` and `want` are token sequences; at the
    first position i where they differ, `scores(i)` is the f32 score
    vector whose argmax picks token i. The divergence passes only if the
    margin there, the best score minus the lower of the two chosen
    tokens' scores, is under `tol`. Returns (i, margin), or (None, None)
    for equal sequences."""
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            s = scores(i).double()
            margin = float(s.max() - torch.minimum(s[a], s[b]))
            assert margin < tol, (
                f"tokens diverge at {i} ({a} vs {b}) with margin {margin} "
                f">= {tol}: not a near-tie")
            return i, margin
    assert len(got) == len(want), (len(got), len(want))
    return None, None


def stream_scores(tparams, tcfg, prompt, tokens, *, seed=0, temperature=0.0,
                  top_p=1.0):
    """scores(i) for assert_tokens_agree: the port's teacher-forced logits
    after prompt + tokens[:i], through the stream's sampling lane."""
    def scores(i):
        seq = np.concatenate([prompt, np.asarray(tokens[:i], np.int32)])
        with torch.no_grad():
            logits = tl.forward(tparams, torch.from_numpy(seq[None]).long(),
                                tcfg)[0, -1:].float()
        s, _ = tde.sample_scores(
            logits, torch.tensor([seed]), torch.tensor([len(seq) - 1]),
            torch.tensor([temperature], dtype=torch.float32),
            torch.tensor([top_p], dtype=torch.float32))
        return s[0]
    return scores


def assert_streams_agree(got, want, scores, tol=TOKEN_TOL):
    """(tokens, logprobs) pairs: tokens under the near-tie rule, logprobs
    within LOGPROB_TOL up to the first divergence. Returns the divergence
    index (None if none)."""
    i, _ = assert_tokens_agree(got[0], want[0], scores, tol)
    n = len(got[0]) if i is None else i
    np.testing.assert_allclose(np.asarray(got[1][:n], np.float32),
                               np.asarray(want[1][:n], np.float32),
                               atol=LOGPROB_TOL)
    return i


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=64,
                          dtype="float32", remat=False)
    tcfg = tl.LlamaConfig.tiny(max_seq_len=64)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


# -- the sampler itself --

GRID_SEEDS = np.array([0, 1, 2**31 + 7, 2**32 - 1, 12345, 777], np.uint32)
GRID_POS = np.array([0, 1, 4095, 127, 300, 9], np.int32)


@pytest.mark.parametrize("top_p", [1e-6, 0.5, 0.95, 1.0])
@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0, 1.7])
def test_sample_from_logits_matches_jax(temp, top_p):
    rng = np.random.RandomState(int(temp * 10) * 7 + int(top_p * 100))
    logits = (rng.randn(len(GRID_SEEDS), 32128) * 3).astype(np.float32)
    temps = np.full(len(GRID_SEEDS), temp, np.float32)
    top_ps = np.full(len(GRID_SEEDS), top_p, np.float32)
    want_t, want_lp = (np.asarray(x) for x in jde._sample_from_logits(
        jnp.asarray(logits), jnp.asarray(GRID_SEEDS), jnp.asarray(GRID_POS),
        jnp.asarray(temps), jnp.asarray(top_ps)))
    args = (torch.from_numpy(logits), torch.from_numpy(GRID_SEEDS.astype(np.int64)),
            torch.from_numpy(GRID_POS), torch.from_numpy(temps),
            torch.from_numpy(top_ps))
    got_t, got_lp = tde._sample_from_logits(*args)
    assert got_t.dtype == torch.int32
    scores, _ = tde.sample_scores(*args)
    for r in range(len(GRID_SEEDS)):
        i, _ = assert_tokens_agree([got_t[r]], [want_t[r]],
                                   lambda _, r=r: scores[r])
        if i is None:
            np.testing.assert_allclose(got_lp[r].item(), want_lp[r],
                                       atol=LOGPROB_TOL)
    if temp == 0.0 or top_p == 1e-6:  # the greedy token in both cases
        assert got_t.tolist() == logits.argmax(-1).tolist()


@pytest.mark.parametrize("top_p", [0.5, 1.0])
def test_greedy_first_tokens_equal_the_sampler(top_p):
    """First tokens of an all-greedy batch skip the sampler: its
    temperature-0 tokens and logprobs, bit for bit."""
    rng = np.random.RandomState(5)
    logits = torch.from_numpy((rng.randn(6, 32128) * 3).astype(np.float32))
    lens = GRID_POS.astype(np.int64) + 1
    lanes = (GRID_SEEDS.astype(np.int64), np.zeros(6, np.float32),
             np.full(6, top_p, np.float32))
    got_t, got_lp = tde._sample_first(logits, lens, lanes)
    want_t, want_lp = tde._sample_from_logits(
        logits, *(torch.from_numpy(x) for x in
                  (lanes[0], lens - 1, lanes[1], lanes[2])))
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_lp.view(torch.int32), want_lp.view(torch.int32))


# -- the engine: counterparts of tests/test_decode_sampling.py --

def _run_stream(eng, prompt, n, *, temperature, seed, top_p=1.0,
                extra_streams=0, rng_seed=99):
    """Decode one stream on `eng` (optionally amid unrelated sampled
    streams) and return (tokens, logprobs)."""
    rng = np.random.RandomState(rng_seed)
    others = [eng.submit(rng.randint(1, 250, 6).astype(np.int32), n,
                         temperature=0.7, seed=int(rng.randint(2**31)))
              for _ in range(extra_streams)]
    sid = eng.submit(np.asarray(prompt, np.int32), n,
                     temperature=temperature, top_p=top_p, seed=seed)
    eng.drain()
    s = eng.pop_finished(sid)
    for o in others:
        eng.purge(o)
    return (np.asarray(s.tokens[:n]), np.asarray(s.logprobs[:n], np.float32))


def _both(models, prompt, n, slots=2, **kw):
    """(port, JAX) results of the same stream on engines of `slots` slots."""
    jcfg, jparams, tcfg, tparams = models
    got = _run_stream(tde.RaggedDecoder(tparams, tcfg, slots=slots,
                                        device="cpu", **ENGINE),
                      prompt, n, **kw)
    want = _run_stream(jde.RaggedDecoder(jparams, jcfg, slots=slots, **ENGINE),
                       prompt, n, **kw)
    return got, want


def _scores(models, prompt, toks, **lane):
    return stream_scores(models[3], models[2], prompt, toks, **lane)


def _greedy(models, prompt, n):
    _, _, tcfg, tparams = models
    return tl.greedy_generate(tparams, torch.from_numpy(prompt[None]), tcfg,
                              n)[0, len(prompt):].numpy()


def test_temperature_zero_is_bit_identical_to_greedy(models):
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    got, want = _both(models, prompt, 12, temperature=0.0, seed=5)
    np.testing.assert_array_equal(got[0], _greedy(models, prompt, 12))
    assert len(got[1]) == len(got[0]) and np.all(got[1] <= 0.0)
    assert_streams_agree(got, want, _scores(models, prompt, got[0]))


def test_sampling_is_deterministic_and_seed_sensitive(models):
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    a, want = _both(models, prompt, 10, temperature=1.0, seed=123)
    _, _, tcfg, tparams = models
    eng = tde.RaggedDecoder(tparams, tcfg, slots=2, device="cpu", **ENGINE)
    b = _run_stream(eng, prompt, 10, temperature=1.0, seed=123)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    c = _run_stream(eng, prompt, 10, temperature=1.0, seed=124)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], _greedy(models, prompt, 10))
    assert_streams_agree(a, want, _scores(models, prompt, a[0], seed=123,
                                          temperature=1.0))


def test_seed_replay_independent_of_batch_composition(models):
    """The same (prompt, seed) alone on a 2-slot engine and amid 3
    unrelated sampled streams on a 4-slot one: the lanes are (seed,
    position), never slot- or batch-dependent. The two port runs' products
    differ in shape, so they too are held to the near-tie rule."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=0.9, seed=777)
    alone, want_alone = _both(models, prompt, 10, slots=2, **lane)
    crowded, want_crowded = _both(models, prompt, 10, slots=4,
                                  extra_streams=3, rng_seed=41, **lane)
    scores = _scores(models, prompt, alone[0], **lane)
    assert_streams_agree(alone, crowded, scores)
    assert_streams_agree(alone, want_alone, scores)
    assert_streams_agree(crowded, want_crowded,
                         _scores(models, prompt, crowded[0], **lane))


def test_tiny_top_p_recovers_greedy(models):
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=1.3, top_p=1e-6, seed=9)
    got, want = _both(models, prompt, 10, **lane)
    np.testing.assert_array_equal(got[0], _greedy(models, prompt, 10))
    assert_streams_agree(got, want, _scores(models, prompt, got[0], **lane))


def test_logprobs_match_teacher_forced_forward(models):
    """Behaviour logprobs == log_softmax of the full forward at the sampled
    tokens (temperature 1, top_p 1), within test_decode_sampling.py's
    1e-4."""
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 250, 8).astype(np.int32)
    lane = dict(temperature=1.0, seed=1234)
    got, want = _both(models, prompt, 8, **lane)
    seq = np.concatenate([prompt, got[0]]).astype(np.int64)
    with torch.no_grad():
        logits = tl.forward(tparams, torch.from_numpy(seq[None]), tcfg)[0].float()
    lsm = torch.log_softmax(logits, dim=-1)
    ref = np.array([lsm[len(prompt) - 1 + t, got[0][t]].item()
                    for t in range(len(got[0]))], np.float32)
    np.testing.assert_allclose(got[1], ref, atol=1e-4)
    assert_streams_agree(got, want, _scores(models, prompt, got[0], **lane))


def test_disaggregated_prefill_samples_same_first_token(models):
    """prefill_kv_sampled samples the SAME first token/logprob as an
    inline sampled admission, and the adopted stream continues alike; the
    JAX worker's payload (numpy f32) adopted by the port continues as the
    JAX engine's inline stream does."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=1.0, seed=4321)
    inline, want = _both(models, prompt, 10, **lane)
    padded = np.zeros((1, 8), np.int32)
    padded[0, :len(prompt)] = prompt
    k, v, tok0, lp0 = tde.prefill_kv_sampled(
        tparams, torch.from_numpy(padded), [len(prompt)], [4321], [1.0],
        [1.0], tcfg, 64)
    assert int(tok0[0]) == int(inline[0][0])
    np.testing.assert_allclose(float(lp0[0]), inline[1][0], atol=LOGPROB_TOL)
    jk, jv, jt0, jlp0 = jde.prefill_kv_sampled(
        jparams, jnp.asarray(padded), jnp.asarray([len(prompt)], jnp.int32),
        jnp.asarray([4321], jnp.uint32), jnp.asarray([1.0], jnp.float32),
        jnp.asarray([1.0], jnp.float32), jcfg, 64)
    np.testing.assert_allclose(k[:, 0].numpy(), np.asarray(jk[:, 0]), atol=1e-5)
    scores = _scores(models, prompt, inline[0], **lane)
    for payload in ({"k": k[:, 0], "v": v[:, 0], "first_token": int(tok0[0]),
                     "first_logprob": float(lp0[0])},
                    {"k": np.asarray(jk[:, 0]), "v": np.asarray(jv[:, 0]),
                     "first_token": int(jt0[0]),
                     "first_logprob": float(jlp0[0])}):
        eng = tde.RaggedDecoder(tparams, tcfg, slots=2, device="cpu", **ENGINE)
        sid = eng.submit_prefilled(prompt, 10, {**payload,
                                                "true_len": len(prompt)}, **lane)
        eng.drain()
        s = eng.pop_finished(sid)
        got = (np.asarray(s.tokens[:10]), np.asarray(s.logprobs[:10], np.float32))
        assert_streams_agree(got, inline, scores)
        assert_streams_agree(got, want, scores)


def test_take_tokens_streams_logprobs_in_lockstep(models):
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(7)
    prompt = rng.randint(1, 250, 6).astype(np.int32)
    eng = tde.RaggedDecoder(tparams, tcfg, slots=2, device="cpu", **ENGINE)
    sid = eng.submit(prompt, 9, temperature=0.8, seed=55)
    got_t, got_l, done = [], [], False
    while not done:
        eng.pump()
        new, lps, done = eng.take_tokens(sid, with_logprobs=True)
        assert len(new) == len(lps)
        got_t.extend(new)
        got_l.extend(lps)
    lane = dict(temperature=0.8, seed=55)
    ref, want = _both(models, prompt, 9, **lane)
    np.testing.assert_array_equal(np.asarray(got_t[:9]), ref[0])
    np.testing.assert_array_equal(np.asarray(got_l[:9], np.float32), ref[1])
    assert eng.take_tokens(sid, with_logprobs=True) == ([], [], True)
    assert eng.take_tokens(sid) == ([], True)
    assert_streams_agree(ref, want, _scores(models, prompt, ref[0], **lane))


@pytest.mark.parametrize("top_p", [0.0, 1.5])
def test_submit_validates_top_p(models, top_p):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(slots=2, max_len=64, chunk_tokens=4, prompt_buckets=(8,))
    with pytest.raises(ValueError) as want:
        jde.RaggedDecoder(jparams, jcfg, **kw).submit(
            [1, 2, 3], 4, temperature=1.0, top_p=top_p)
    with pytest.raises(ValueError) as got:
        tde.RaggedDecoder(tparams, tcfg, device="cpu", **kw).submit(
            [1, 2, 3], 4, temperature=1.0, top_p=top_p)
    assert str(got.value) == str(want.value)


def test_stats_carry_version_and_pumps(models):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(slots=2, max_len=64, chunk_tokens=4, prompt_buckets=(8,),
              weights_version=7)
    got = tde.RaggedDecoder(tparams, tcfg, device="cpu", **kw)
    want = jde.RaggedDecoder(jparams, jcfg, **kw)
    for eng in (got, want):
        assert eng.stats()["weights_version"] == 7
        assert eng.stats()["pumps"] == 0
        sid = eng.submit([1, 2, 3], 2)
        eng.pump()
        assert eng.stats()["pumps"] == 1
        assert eng.stream_version(sid) == 7
        eng.set_params(eng.params, 9)
        assert eng.stats()["weights_version"] == 9
        assert eng.stream_version(sid) == 7
    assert set(got.stats()) == set(want.stats())
