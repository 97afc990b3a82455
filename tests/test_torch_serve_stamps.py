"""Per-token stamps of the port's RaggedDecoder against the JAX engine's.

The same seeded requests run through both engines on the CPU in f32 over
each path that stamps tokens: greedy, sampled, speculative (depth 2),
prefilled (KV adopted from each package's own prefill_kv_sampled) and a
pump with an emulated dispatch delay. Stamps are time.perf_counter()
values, so they cannot equal JAX's; what must match is their count per
stream and the pattern of equal stamps: one stamp per pump, repeated for
every token that pump delivered (a cold stream's first token lands with
its first chunk; a prefilled stream's is stamped at admission). Every
stream is stamped after its submit, and its stamps never decrease.
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
SAMPLED = dict(temperature=0.8, top_p=0.95)
DELAY_S = 0.01


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


def _lanes(path):
    if path in ("sampled", "prefilled"):
        return [dict(SAMPLED, seed=100 + i) for i in range(len(PROMPT_LENS))]
    return [{}] * len(PROMPT_LENS)


def _payloads(models, port, prompts, lanes):
    """Each prompt's prefill payload from its own package's worker op."""
    jcfg, jparams, tcfg, tparams = models
    out = []
    for p, lane in zip(prompts, lanes):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(p)] = p
        args = ([len(p)], [lane.get("seed", 0)],
                [lane.get("temperature", 0.0)], [lane.get("top_p", 1.0)])
        if port:
            k, v, t0, lp0 = tde.prefill_kv_sampled(
                tparams, torch.from_numpy(padded), *args, tcfg, 64)
        else:
            k, v, t0, lp0 = jde.prefill_kv_sampled(
                jparams, jnp.asarray(padded), jnp.asarray(args[0], jnp.int32),
                jnp.asarray(args[1], jnp.uint32),
                jnp.asarray(args[2], jnp.float32),
                jnp.asarray(args[3], jnp.float32), jcfg, 64)
        out.append({"k": np.asarray(k[:, 0]), "v": np.asarray(v[:, 0]),
                    "first_token": int(t0[0]), "first_logprob": float(lp0[0]),
                    "true_len": len(p)})
    return out


def _run(models, port, path):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(ENGINE)
    if path == "spec":
        kw.update(spec_depth=2, spec_draft_layers=1)
    if path == "delay":
        kw.update(chunk_delay_s=DELAY_S)
    eng = (tde.RaggedDecoder(tparams, tcfg, device="cpu", **kw) if port
           else jde.RaggedDecoder(jparams, jcfg, **kw))
    prompts, lanes = _prompts(), _lanes(path)
    if path == "prefilled":
        sids = [eng.submit_prefilled(p, n, kv, **lane) for p, n, kv, lane in
                zip(prompts, MAX_NEW, _payloads(models, port, prompts, lanes),
                    lanes)]
    else:
        sids = [eng.submit(p, n, **lane)
                for p, n, lane in zip(prompts, MAX_NEW, lanes)]
    eng.drain()
    return [eng.pop_finished(s) for s in sids]


def _runs_of_equal(stamps):
    """Lengths of the runs of equal consecutive stamps."""
    out = []
    for i, t in enumerate(stamps):
        if i and t == stamps[i - 1]:
            out[-1] += 1
        else:
            out.append(1)
    return out


@pytest.mark.parametrize("path", ["greedy", "sampled", "spec", "prefilled",
                                  "delay"])
def test_stamps_match_jax_engine(models, path):
    got, want = _run(models, True, path), _run(models, False, path)
    for g, w, n in zip(got, want, MAX_NEW):
        assert len(g.tokens) == n and len(g.token_times) == n
        assert len(w.token_times) == n
        assert _runs_of_equal(g.token_times) == _runs_of_equal(w.token_times)
        assert g.submitted <= g.token_times[0]
        assert all(b >= a for a, b in zip(g.token_times, g.token_times[1:]))
    if path == "delay":
        # every pump sleeps before its fetch: successive stamps of a
        # stream are at least one delay apart
        for g in got:
            distinct = sorted(set(g.token_times))
            assert all(b - a >= DELAY_S
                       for a, b in zip(distinct, distinct[1:]))

