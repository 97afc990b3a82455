"""ray_tpu_torch.models.llama against ray_tpu.models.llama on the CPU.

JAX-initialised params cross over with ``from_jax_params`` (numpy in
between), then forward logits, the loss, prefill + decode through the KV
cache, and greedy tokens are compared. Tolerance: f32 atol=1e-4 on
logits of the tiny configs (a few matmuls deep, summed in other orders);
greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl

ATOL = 1e-4
CONFIGS = {
    "tiny": {},                    # GQA 4/2
    "tiny_gqa4": {"n_kv_heads": 1},  # GQA 4/1
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    kw = CONFIGS[request.param]
    jcfg = jl.LlamaConfig.tiny(remat=False, **kw)
    tcfg = tl.LlamaConfig.tiny(**kw)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tl.from_jax_params(np_tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(1, 250, (b, t)).astype(np.int32)


def test_param_tree_and_count(models):
    jcfg, jparams, tcfg, tparams = models
    assert tcfg.num_params() == jcfg.num_params()
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams)) \
        == sum(x.numel() for x in jax.tree_util.tree_leaves(tparams))
    assert tparams["layers"]["attn_norm"].dtype == torch.float32
    assert tparams["layers"]["wq"].shape == tuple(jparams["layers"]["wq"].shape)


def test_forward_logits(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(2, 24)
    want = np.asarray(jl.forward(jparams, jnp.asarray(toks), jcfg), np.float32)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_loss_fn(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(2, 17, seed=1)
    lj, mj = jl.loss_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    lt, mt = tl.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL)
    assert float(mt["tokens"]) == float(mj["tokens"])


def test_prefill_then_decode_with_cache(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(2, 12, seed=2)
    jc = jl.init_cache(jcfg, 2, 32)
    tc = tl.init_cache(tcfg, 2, 32, device="cpu")
    lj, jc = jl.forward_with_cache(jparams, jnp.asarray(toks[:, :8]), jcfg, jc)
    lt, tc = tl.forward_with_cache(tparams, torch.from_numpy(toks[:, :8]), tcfg, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for i in range(8, 12):
        lj, jc = jl.forward_with_cache(jparams, jnp.asarray(toks[:, i:i + 1]), jcfg, jc)
        lt, tc = tl.forward_with_cache(tparams, torch.from_numpy(toks[:, i:i + 1]), tcfg, tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == 12
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=ATOL)
    # the cached decode equals the full forward at the same positions
    full = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(), atol=ATOL)


def test_greedy_generate_tokens_identical(models):
    jcfg, jparams, tcfg, tparams = models
    prompt = _tokens(2, 6, seed=3)
    want = np.asarray(jl.greedy_generate(jparams, jnp.asarray(prompt), jcfg, 10))
    got = tl.greedy_generate(tparams, torch.from_numpy(prompt), tcfg, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    new, cache = tl.generate_scan(tparams, torch.from_numpy(prompt), tcfg, 10,
                                  tl.init_cache(tcfg, 2, 16, device="cpu"))
    np.testing.assert_array_equal(new.numpy(), want[:, 6:])
    assert cache["pos"] == 15


def test_init_params_law_and_dtypes():
    cfg = tl.LlamaConfig.tiny(dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    p = tl.init_params(cfg, g, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert p["final_norm"].dtype == torch.float32
    w = p["layers"]["w_gate"].float()
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    again = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["lm_head"], again["lm_head"])
    toks = torch.from_numpy(_tokens(1, 8))
    assert tl.forward(p, toks, cfg).dtype == torch.bfloat16
