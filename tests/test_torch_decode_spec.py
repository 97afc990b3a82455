"""Speculative decoding in the port against plain decoding and the JAX engine.

Counterparts of tests/test_decode_spec.py (the live-config and chaos
cases belong to the serving wrappers), plus a slot that speculates within
K rows of the cache end. In JAX spec output is bit-identical to plain
output; in the port the verify runs its products at B*(K+1) rows where a
decode step runs them at B, so the port's spec and plain runs, and both
against the JAX engine, are held to the near-tie rule of
tests/test_torch_sampling.py (TOKEN_TOL = 1e-4 in f32; logprobs within
1e-5 up to a divergence).
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_engine as jde
from ray_tpu.models import llama as jl
from ray_tpu.models import mlp as jmlp
from ray_tpu_torch.models import decode_engine as tde
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import mlp as tmlp
from test_torch_sampling import assert_streams_agree, stream_scores


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


def _engine(models, port, *, spec_depth=0, draft_layers=1, draft_head=None,
            slots=4, max_len=64, chunk=4):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(slots=slots, max_len=max_len, chunk_tokens=chunk,
              prompt_buckets=(8, 16), spec_depth=spec_depth,
              spec_draft_layers=draft_layers, spec_draft_head=draft_head)
    if port:
        return tde.RaggedDecoder(tparams, tcfg, device="cpu", **kw)
    return jde.RaggedDecoder(jparams, jcfg, **kw)


def _run(eng, prompt, n, *, temperature, seed, extra_streams=0, rng_seed=99):
    rng = np.random.RandomState(rng_seed)
    others = [eng.submit(rng.randint(1, 250, 6).astype(np.int32), n,
                         temperature=0.7, seed=int(rng.randint(2**31)))
              for _ in range(extra_streams)]
    sid = eng.submit(np.asarray(prompt, np.int32), n,
                     temperature=temperature, seed=seed)
    eng.drain()
    s = eng.pop_finished(sid)
    for o in others:
        eng.purge(o)
    return ((np.asarray(s.tokens[:n]), np.asarray(s.logprobs[:n], np.float32)),
            eng.stats())


def _scores(models, prompt, toks, temperature, seed):
    return stream_scores(models[3], models[2], prompt, toks,
                         temperature=temperature, seed=seed)


@pytest.mark.parametrize("depth", [2, 4])
def test_spec_greedy_matches_plain(models, depth):
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=0.0, seed=5)
    base, _ = _run(_engine(models, True), prompt, 16, **lane)
    got, st = _run(_engine(models, True, spec_depth=depth), prompt, 16, **lane)
    want, _ = _run(_engine(models, False, spec_depth=depth), prompt, 16, **lane)
    scores = _scores(models, prompt, base[0], **lane)
    assert_streams_agree(got, base, scores)
    assert_streams_agree(got, want, scores)
    assert st["spec"]["pumps"] > 0
    # greedy-only engine: the first token's logprob, then placeholders
    assert got[1][0] < 0.0 and np.all(got[1][1:] == 0.0)


def test_spec_sampled_seed_replay_across_depths(models):
    """One (prompt, seed) decoded plain, at depth 2, at depth 4 and at
    depth 4 amid unrelated streams gives the same tokens."""
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=0.9, seed=777)
    base, _ = _run(_engine(models, True), prompt, 14, **lane)
    scores = _scores(models, prompt, base[0], **lane)
    d2, _ = _run(_engine(models, True, spec_depth=2), prompt, 14, **lane)
    d4, st = _run(_engine(models, True, spec_depth=4), prompt, 14, **lane)
    crowd, _ = _run(_engine(models, True, spec_depth=4), prompt, 14,
                    extra_streams=3, rng_seed=41, **lane)
    want, _ = _run(_engine(models, False, spec_depth=4), prompt, 14, **lane)
    for got in (d2, d4, crowd, want):
        assert_streams_agree(got, base, scores)
    # with a real draft trunk some drafts must actually be accepted
    assert st["spec"]["accepted"] > 0


def test_spec_stats_block(models):
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=0.8, seed=11)
    got, st = _run(_engine(models, True, spec_depth=4), prompt, 16, **lane)
    want, jst = _run(_engine(models, False, spec_depth=4), prompt, 16, **lane)
    assert_streams_agree(got, want, _scores(models, prompt, got[0], **lane))
    sp = st["spec"]
    assert set(sp) == set(jst["spec"])
    assert sp["depth"] == 4 and sp["draft_layers"] == 1
    assert sp["pumps"] > 0
    assert 0 <= sp["accepted"] <= sp["proposed"]
    assert 0.0 <= sp["acceptance_rate"] <= 1.0
    hist = sp["accept_hist"]
    assert hist and all(isinstance(k, str) for k in hist)
    assert sum(hist.values()) == sp["proposed"] // 4
    assert sum(int(k) * v for k, v in hist.items()) == sp["accepted"]


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_spec_near_cache_end(models, temperature):
    """A slot that speculates within K rows of max_len: the verify's rows
    past the cache end are dropped (JAX drops them; a torch index there
    would raise), and the tokens are plain decoding's and the JAX spec
    engine's. 12 prompt tokens in 20 rows leave room for 7 new tokens, so
    the depth-4 rounds run past the end."""
    rng = np.random.RandomState(8)
    prompt = rng.randint(1, 250, 12).astype(np.int32)
    lane = dict(temperature=temperature, seed=99)
    kw = dict(max_len=20, chunk=4, slots=2)
    base, _ = _run(_engine(models, True, **kw), prompt, 16, **lane)
    got, st = _run(_engine(models, True, spec_depth=4, **kw), prompt, 16,
                   **lane)
    want, _ = _run(_engine(models, False, spec_depth=4, **kw), prompt, 16,
                   **lane)
    assert len(base[0]) == 20 - 12 - 1
    scores = _scores(models, prompt, base[0], **lane)
    assert_streams_agree(got, base, scores)
    assert_streams_agree(got, want, scores)
    assert st["spec"]["pumps"] > 0


def test_verify_drops_rows_past_the_cache_end(models):
    """decode_chunk_spec itself, one slot 2 rows from the end at depth 4,
    against JAX's on the same cache: the port's draft writes in place and
    its verify drops the rows past the end, and still every row of the
    cache, pos, the tokens and the counts come out as JAX's (whose draft
    writes a private copy and whose scatter drops those rows)."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(4)
    k0 = rng.randn(2, 2, 16, 2, 16).astype(np.float32)
    v0 = rng.randn(2, 2, 16, 2, 16).astype(np.float32)
    pos0 = np.array([13, 4], np.int32)
    tok0 = np.array([7, 9], np.int32)
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
             "pos": torch.from_numpy(pos0.copy())}
    toks, lps, counts, cache, last = tde.decode_chunk_spec(
        tparams, None, cache, torch.from_numpy(tok0), torch.tensor([True, True]),
        None, None, None, tcfg, 2, 4, 1)
    assert lps is None
    jnp = jax.numpy
    jt, _, jc, jcache, jlast = jde.decode_chunk_spec(
        jparams, None, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
                        "pos": jnp.asarray(pos0)},
        jnp.asarray(tok0), jnp.asarray([True, True]),
        jnp.zeros(2, jnp.uint32), jnp.zeros(2, jnp.float32),
        jnp.ones(2, jnp.float32), jcfg, 2, 4, 1)
    assert toks.tolist() == np.asarray(jt).tolist()
    assert counts.tolist() == np.asarray(jc).tolist()
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    assert int(cache["pos"][0]) == 15  # clamped at max_len - 1
    assert last.tolist() == np.asarray(jlast).tolist()
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-5)


def test_draft_params_is_a_view(models):
    jcfg, jparams, tcfg, tparams = models
    dp = tl.draft_params(tparams, 1)
    for k, v in dp["layers"].items():
        assert v.shape[0] == 1
        assert v.data_ptr() == tparams["layers"][k].data_ptr()
    assert dp["embed"] is tparams["embed"] and dp["lm_head"] is tparams["lm_head"]
    assert tl.draft_config(tcfg, 1).n_layers == 1
    with pytest.raises(ValueError) as want:
        jl.draft_config(jcfg, 3)
    with pytest.raises(ValueError) as got:
        tl.draft_config(tcfg, 3)
    assert str(got.value) == str(want.value)


def test_draft_head_zero_init_is_identity(models):
    """The zero-init head is an exact identity; a JAX head carried across
    (with a non-zero w2) applies as JAX's does; an engine built with the
    zero head gives the tokens of one without it."""
    head = tmlp.init_draft_head(64, device="cpu")
    h = torch.randn((3, 64), generator=torch.Generator().manual_seed(8))
    assert torch.equal(tmlp.apply_draft_head(head, h), h)
    jhead = jmlp.init_draft_head(64, jax.random.PRNGKey(7))
    jhead["w2"] = jax.random.normal(jax.random.PRNGKey(9), jhead["w2"].shape) * 0.1
    thead = tmlp.draft_head_from_jax(jax.tree_util.tree_map(np.asarray, jhead),
                                     device="cpu")
    hx = np.random.RandomState(3).randn(2, 5, 64).astype(np.float32)
    np.testing.assert_allclose(
        tmlp.apply_draft_head(thead, torch.from_numpy(hx)).numpy(),
        np.asarray(jmlp.apply_draft_head(jhead, jax.numpy.asarray(hx))),
        atol=1e-5)
    rng = np.random.RandomState(9)
    prompt = rng.randint(1, 250, 7).astype(np.int32)
    lane = dict(temperature=0.0, seed=5)
    base, _ = _run(_engine(models, True, spec_depth=2), prompt, 12, **lane)
    got, _ = _run(_engine(models, True, spec_depth=2, draft_head=head), prompt,
                  12, **lane)
    np.testing.assert_array_equal(got[0], base[0])
    # the carried head drafts other tokens, never other output
    moved, _ = _run(_engine(models, True, spec_depth=2, draft_head=thead),
                    prompt, 12, **lane)
    assert_streams_agree(moved, base, _scores(models, prompt, base[0], **lane))
