"""The port's mixture-of-experts Llama against ray_tpu.models.llama on the CPU.

The router (``moe_gates``, with logits that tie exactly at the k-th
prob), the capacity of an expert's buffer, the GShard slot assignment
(against a token-by-token loop), both MoE MLPs (``_moe_mlp_dense`` and
``_moe_mlp_capacity`` with and without drops) and their gradients, the
config and parameter tree, and ``moe-tiny``'s forward, loss and greedy
tokens, each from the same seeded numpy inputs through both packages;
then eight train steps of ``moe-tiny`` per impl.

Tolerances. f32: MoE MLP outputs atol=2e-5 / rtol=1e-4
(tests/test_moe.py's), logits atol=1e-4 (tests/test_torch_llama.py's),
gradients within a relative L2 of 1e-4. bf16 MLP outputs: atol=rtol=2e-2,
four roundings to 8 mantissa bits (x, the expert products, the combine)
that the two frameworks place differently; the routing itself must come
out the same (same slots), which the inputs here do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import fused_adamw, init_train_state, make_train_step
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
GRAD_REL_L2 = 1e-4
_JIT_INIT = jax.jit(jl.init_params, static_argnums=0)
SIZES = ("125m", "moe-tiny", "350m", "1b", "7b")
REMAT_POLICIES = ("dots", "dots_flash", "dots_flash_qkv",
                  "dots_flash_qkv_mlp", "flash_qkv", "nothing")


def _cfgs(**kw):
    """One MoE layer's config in both packages (tests/test_moe.py's)."""
    base = dict(vocab_size=128, d_model=64, n_layers=1, n_heads=2,
                n_kv_heads=2, d_ff=128, max_seq_len=32, n_experts=4, top_k=2,
                dtype="float32", remat=False, use_flash=False)
    base.update(kw)
    return jl.LlamaConfig(**base), tl.LlamaConfig(**base)


def _jinit(jcfg, seed=0):
    """JAX's init_params under jit: one compile per parameter shape (the
    routing fields and the dtype do not change the tree)."""
    jcfg = dataclasses.replace(jcfg, moe_impl="capacity", capacity_factor=1.25,
                               dtype="float32")
    return _JIT_INIT(jcfg, jax.random.PRNGKey(seed))


def _layer0(jcfg, seed=0):
    """Layer 0 of JAX's init_params, as numpy arrays."""
    p = _jinit(jcfg, seed)
    return {k: np.asarray(v[0]) for k, v in p["layers"].items()}


def _both(np_layer, x):
    jp = {k: jnp.asarray(v) for k, v in np_layer.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in np_layer.items()}
    return jp, tp, jnp.asarray(x), torch.from_numpy(np.array(x))


def _jmlp(jcfg):
    """JAX's _moe_mlp under jit: one compile instead of one per op."""
    return jax.jit(lambda p, x: jl._moe_mlp(jcfg, p, x))


def _x(b=2, t=32, d=64, seed=1):
    return np.random.RandomState(seed).randn(b, t, d).astype(np.float32)


def _slots_loop(topi, capacity, n_experts):
    """GShard slots by a token-by-token loop: all first choices of a row
    in token order, then all second choices, each taking its expert's
    next free slot (>= capacity: dropped)."""
    b, t, k = topi.shape
    pos = np.zeros((b, t, k), np.int64)
    for r in range(b):
        count = [0] * n_experts
        for j in range(k):
            for i in range(t):
                pos[r, i, j] = count[topi[r, i, j]]
                count[topi[r, i, j]] += 1
    return pos


def _jax_capacity(jcfg, t):
    """The capacity JAX's _moe_mlp_capacity uses for rows of t tokens:
    the C of its expert buffer xe [B, E, C, D], read off the traced
    program (D = 3 is unique among the dimensions)."""
    cfg = jl.LlamaConfig(**{**jcfg.__dict__, "d_model": 3, "d_ff": 5})
    p = {"router": jnp.zeros((3, cfg.n_experts)),
         "w_gate": jnp.zeros((cfg.n_experts, 3, 5)),
         "w_up": jnp.zeros((cfg.n_experts, 3, 5)),
         "w_down": jnp.zeros((cfg.n_experts, 5, 3))}
    jaxpr = jax.make_jaxpr(lambda x: jl._moe_mlp_capacity(cfg, p, x))(
        jax.ShapeDtypeStruct((1, t, 3), jnp.float32))
    caps = {v.aval.shape[2] for eqn in jaxpr.eqns for v in eqn.outvars
            if len(v.aval.shape) == 4
            and v.aval.shape[:2] == (1, cfg.n_experts)
            and v.aval.shape[3] == 3}
    (cap,) = caps
    return cap


# -- config and parameters --

@pytest.mark.parametrize("name", SIZES)
def test_every_jax_config_converts(name):
    jcfg = jl.llama2_size(name)
    tcfg = tl.LlamaConfig(**jcfg.__dict__)
    assert tcfg == tl.llama2_size(name)
    assert tcfg.num_params() == jcfg.num_params()
    assert tl.param_logical_axes(tcfg) == jl.param_logical_axes(jcfg)
    shapes = tl._shapes(tcfg)
    want = jax.eval_shape(lambda: jl.init_params(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        shapes, is_leaf=lambda s: isinstance(s, tuple))
    for got, w in zip(jax.tree_util.tree_leaves(
            shapes, is_leaf=lambda s: isinstance(s, tuple)),
            jax.tree_util.tree_leaves(want)):
        assert got == w.shape


def test_llama2_7b_and_the_1b_moe_config():
    assert tl.llama2_7b() == tl.LlamaConfig(**jl.llama2_7b().__dict__)
    over = {"vocab_size": 32128, "n_experts": 8, "top_k": 2}
    jcfg = jl.LlamaConfig(**{**jl.llama2_size("1b").__dict__, **over})
    tcfg = tl.LlamaConfig(**{**tl.llama2_size("1b").__dict__, **over})
    assert tcfg.num_params() == jcfg.num_params() == 6_499_002_368
    eight = tl.LlamaConfig(**{**tcfg.__dict__, "n_layers": 8})
    assert eight.num_params() == 2_447_017_984
    with pytest.raises(KeyError):
        tl.llama2_size("moe-huge")


def test_from_jax_params_carries_the_expert_leaves():
    jcfg = jl.llama2_size("moe-tiny")
    tcfg = tl.LlamaConfig(**{**jcfg.__dict__, "dtype": "float32"})
    jparams = _jinit(jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tl.from_jax_params(np_tree, tcfg, device="cpu")
    assert set(tparams["layers"]) == set(np_tree["layers"]) >= {
        "router", "w_gate", "w_up", "w_down"}
    for path, t, j in zip(tree_paths(tparams), tree_leaves(tparams),
                          jax.tree_util.tree_leaves(np_tree)):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
    # the draft view and the per-layer views slice the expert leaves too
    draft = tl.draft_params(tparams, 1)
    assert draft["layers"]["w_down"].shape == (1, 4, 256, 128)
    layer1 = tl._unbind_layers(tparams)[1]
    assert torch.equal(layer1["router"], tparams["layers"]["router"][1])
    # a wrong expert count is refused, not broadcast
    with pytest.raises(ValueError, match="param shape"):
        tl.from_jax_params(np_tree, tl.LlamaConfig(
            **{**tcfg.__dict__, "n_experts": 8}), device="cpu")


def test_init_params_expert_leaves_follow_the_init_law():
    cfg = tl.LlamaConfig(**{**tl.llama2_size("moe-tiny").__dict__,
                            "n_layers": 1})
    p = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    layers = p["layers"]
    assert layers["router"].shape == (1, 128, 4)
    assert layers["w_gate"].dtype == torch.bfloat16
    for name, fan_in in (("router", 128), ("w_gate", 128), ("w_up", 128),
                         ("w_down", 256)):
        std = layers[name].float().std().item() * np.sqrt(fan_in)
        assert abs(std - 1.0) < 0.1, name
    assert sum(x.numel() for x in tree_leaves(p)) == cfg.num_params()


# -- router, capacity and slots --

@pytest.mark.parametrize("t", [1, 5, 7, 128, 2048])
@pytest.mark.parametrize("e", [4, 8])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0])
def test_capacity_equals_jax(t, e, k, cf):
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    assert tl.moe_capacity(tcfg, t) == _jax_capacity(jcfg, t)


def _tied_router_inputs(b=2, t=12, d=8, e=4):
    """x and a router whose logits are exact in f32 (small integers times
    multiples of 1/8) and tie exactly at the 2nd largest prob: expert 0
    leads every token (logit 4), experts 1 and 2 share one column
    (|logit| <= 7/8), expert 3 trails (logit -4)."""
    rng = np.random.RandomState(5)
    x = rng.randint(-1, 2, (b, t, d)).astype(np.float32)
    x[..., 0] = 1.0
    router = np.zeros((d, e), np.float32)
    router[0, 0], router[0, 3] = 4.0, -4.0
    router[1:, 1] = router[1:, 2] = rng.randint(-1, 2, d - 1) / 8.0
    return x, router


def test_moe_gates_exact_tie_matches_jax():
    jcfg, tcfg = _cfgs(d_model=8)
    x, router = _tied_router_inputs()
    want = np.asarray(jax.jit(lambda r, x_: jl.moe_gates(jcfg, r, x_))(
        jnp.asarray(router), jnp.asarray(x)))
    got = tl.moe_gates(tcfg, torch.from_numpy(router),
                       torch.from_numpy(x)).numpy()
    # the two softmaxes' exps may differ in the last bit; the tie may not
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the tie keeps three experts per token, renormalised over them
    assert ((got > 0).sum(-1) == 3).all()
    assert (got[..., 1] == got[..., 2]).all()
    assert (want[..., 1] == want[..., 2]).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    # top_k's order: equal gates by the lower expert index
    jv, ji = jax.lax.top_k(jnp.asarray(want), 2)
    cap = tl.moe_capacity(tcfg, x.shape[1])
    tv, ti, pos = tl._capacity_slots(tcfg, torch.from_numpy(got), cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert (ti[..., 1] == 1).all()
    np.testing.assert_array_equal(pos.numpy(), _slots_loop(ti.numpy(), cap, 4))


@pytest.mark.parametrize("impl,cf", [("capacity", 0.25), ("capacity", 1.25),
                                     ("dense", 1.25)])
def test_moe_mlp_with_tied_router_matches_jax(impl, cf):
    jcfg, tcfg = _cfgs(d_model=8, d_ff=16, moe_impl=impl, capacity_factor=cf)
    x, router = _tied_router_inputs()
    layer = _layer0(jcfg)
    layer["router"] = router
    jp, tp, jx, tx = _both(layer, x)
    want = np.asarray(_jmlp(jcfg)(jp, jx))
    np.testing.assert_allclose(tl._moe_mlp(tcfg, tp, tx).numpy(), want, **F32)


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25])
def test_slots_match_a_token_loop(cf):
    _, tcfg = _cfgs(capacity_factor=cf, n_experts=8)
    rng = np.random.RandomState(3)
    gates = torch.softmax(torch.from_numpy(
        rng.randn(3, 40, 8).astype(np.float32)), dim=-1)
    cap = tl.moe_capacity(tcfg, 40)
    topv, topi, pos = tl._capacity_slots(tcfg, gates, cap)
    np.testing.assert_array_equal(pos.numpy(), _slots_loop(topi.numpy(), cap, 8))
    assert pos.dtype == torch.int32
    if cf < 1.0:
        assert (pos >= cap).any()


# -- the MoE MLP --

@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("capacity", 0.25),
                                     ("capacity", 1.25), ("capacity", 4.0)])
def test_moe_mlp_matches_jax_f32(impl, cf):
    jcfg, tcfg = _cfgs(moe_impl=impl, capacity_factor=cf)
    jp, tp, jx, tx = _both(_layer0(jcfg), _x())
    want = np.asarray(_jmlp(jcfg)(jp, jx))
    got = tl._moe_mlp(tcfg, tp, tx)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("capacity", 0.25),
                                     ("capacity", 1.25)])
def test_moe_mlp_matches_jax_bf16(impl, cf):
    jcfg, tcfg = _cfgs(moe_impl=impl, capacity_factor=cf, dtype="bfloat16")
    x = _x()
    layer = _layer0(jcfg)
    jp = {k: jnp.asarray(v) for k, v in layer.items()}
    tp = {k: torch.from_numpy(np.array(v)).bfloat16() for k, v in layer.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    # the same routing in both: the bf16 router logits agree
    cap = tl.moe_capacity(tcfg, 32)
    jg = jax.jit(lambda r, x_: jl.moe_gates(jcfg, r, x_))(jp["router"], jx)
    tg = tl.moe_gates(tcfg, tp["router"], tx)
    np.testing.assert_array_equal(
        tl._capacity_slots(tcfg, tg, cap)[1].numpy(),
        np.asarray(jax.lax.top_k(jg, 2)[1]))
    want = np.asarray(_jmlp(jcfg)(jp, jx).astype(jnp.float32))
    got = tl._moe_mlp(tcfg, tp, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_capacity_equals_dense_when_nothing_drops():
    _, dense = _cfgs(moe_impl="dense")
    _, cap = _cfgs(moe_impl="capacity", capacity_factor=4.0)
    _, tp, _, tx = _both(_layer0(_cfgs()[0]), _x(seed=2))
    np.testing.assert_allclose(tl._moe_mlp(cap, tp, tx).numpy(),
                               tl._moe_mlp(dense, tp, tx).numpy(), **F32)
    _, low = _cfgs(moe_impl="capacity", capacity_factor=0.25)
    y_low = tl._moe_mlp(low, tp, tx)
    assert torch.isfinite(y_low).all()
    assert not torch.allclose(y_low, tl._moe_mlp(dense, tp, tx), atol=1e-3)


def test_dropped_choices_get_exact_zero_rows():
    """One token per row past capacity 1: the rows of dropped choices
    contribute nothing, and a token whose both choices drop outputs 0."""
    _, tcfg = _cfgs(n_experts=2, top_k=1, capacity_factor=0.25)
    _, tp, _, tx = _both(_layer0(_cfgs(n_experts=2, top_k=1)[0]), _x(t=6))
    cap = tl.moe_capacity(tcfg, 6)
    assert cap == 1
    gates = tl.moe_gates(tcfg, tp["router"], tx)
    _, _, pos = tl._capacity_slots(tcfg, gates, cap)
    _, topi, _ = tl._capacity_slots(tcfg, gates, cap)
    y = tl._moe_mlp(tcfg, tp, tx)
    dropped = pos[..., 0] >= cap
    for r in range(2):  # each expert a row uses keeps its first token
        assert int(dropped[r].sum()) == 6 - len(set(topi[r, :, 0].tolist()))
    assert (y[dropped] == 0).all() and (y[~dropped] != 0).all(dim=-1).all()


def test_unknown_moe_impl_raises_the_reference_error():
    jcfg, tcfg = _cfgs(moe_impl="sparse")
    jp, tp, jx, tx = _both(_layer0(_cfgs()[0]), _x())
    with pytest.raises(ValueError) as j_err:
        jl._moe_mlp(jcfg, jp, jx)
    with pytest.raises(ValueError) as t_err:
        tl._moe_mlp(tcfg, tp, tx)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("capacity", 0.25),
                                     ("capacity", 1.25)])
def test_moe_mlp_gradients_match_jax(impl, cf):
    jcfg, tcfg = _cfgs(moe_impl=impl, capacity_factor=cf)
    layer = {k: v for k, v in _layer0(jcfg).items()
             if k in ("router", "w_gate", "w_up", "w_down")}
    x = _x(seed=4)
    cot = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    jp, tp, jx, tx = _both(layer, x)

    def jloss(p, x_):
        return jnp.sum(jl._moe_mlp(jcfg, p, x_) * cot)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    for v in list(tp.values()) + [tx]:
        v.requires_grad_()
    loss = (tl._moe_mlp(tcfg, tp, tx) * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, list(tp.values()) + [tx])
    for name, g, w in zip(list(tp) + ["x"], grads,
                          [want_p[k] for k in tp] + [want_x]):
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL_L2, (name, rel)


# -- the model --

@pytest.fixture(scope="module", params=["capacity", "dense"])
def moe_tiny(request):
    jcfg = jl.LlamaConfig(**{**jl.llama2_size("moe-tiny").__dict__,
                             "dtype": "float32", "remat": False,
                             "use_flash": False, "moe_impl": request.param})
    tcfg = tl.LlamaConfig(**{**jcfg.__dict__, "use_flash": None})
    jparams = _jinit(jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tl.from_jax_params(np_tree, tcfg, device="cpu")


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(1, 500, (b, t)).astype(np.int32)


def test_moe_tiny_forward_and_loss(moe_tiny):
    jcfg, jparams, tcfg, tparams = moe_tiny
    toks = _tokens(2, 24)
    want = np.asarray(jax.jit(lambda p, x: jl.forward(p, x, jcfg))(
        jparams, jnp.asarray(toks)))
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    toks = _tokens(2, 17, seed=1)
    lj, mj = jax.jit(lambda p, b: jl.loss_fn(p, b, jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    lt, mt = tl.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-4)
    assert float(mt["tokens"]) == float(mj["tokens"])


def test_moe_tiny_greedy_generate(moe_tiny):
    jcfg, jparams, tcfg, tparams = moe_tiny
    prompt = _tokens(2, 9, seed=3)
    want = np.asarray(jl.greedy_generate(jparams, jnp.asarray(prompt), jcfg, 12))
    got = tl.greedy_generate(tparams, torch.from_numpy(prompt), tcfg, 12)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def moe_master():
    cfg = tl.LlamaConfig(**{**tl.llama2_size("moe-tiny").__dict__,
                            "dtype": "float32", "vocab_size": 128})
    return cfg, tl.init_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu", master=True)


def _grads(cfg, params, toks):
    leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(params)]
    loss, _ = tl.loss_fn(tree_unflatten(params, leaves),
                         {"tokens": torch.from_numpy(toks)}, cfg)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("impl", ["capacity", "dense"])
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_policy_changes_no_moe_gradient(policy, impl, moe_master):
    cfg, params = moe_master
    cfg = tl.LlamaConfig(**{**cfg.__dict__, "moe_impl": impl,
                            "capacity_factor": 0.5})
    toks = _tokens(2, 17, seed=5) % 128
    want = _grads(tl.LlamaConfig(**{**cfg.__dict__, "remat": False}), params,
                  toks)
    got = _grads(tl.LlamaConfig(**{**cfg.__dict__, "remat_policy": policy}),
                 params, toks)
    for path, g, w in zip(tree_paths(params), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=path)


@pytest.mark.parametrize("impl,saved", [
    # wq, wk, wv, wo and the router: no-batch products, as in JAX
    ("capacity", ["wq", "wk", "wv", "wo", "router"]),
    # + the dense impl's btd,edf products (gate and up over all experts)
    ("dense", ["wq", "wk", "wv", "wo", "router", "experts", "experts"])])
def test_dots_policy_saves_the_no_batch_products(impl, saved, monkeypatch,
                                                 moe_master):
    """Under "dots" a MoE layer saves exactly the products JAX's
    dots_with_no_batch_dims_saveable saves: aten.mm outputs, by shape."""
    cfg, params = moe_master
    cfg = tl.LlamaConfig(**{**cfg.__dict__, "moe_impl": impl,
                            "remat_policy": "dots", "n_layers": 1})
    b, t, d, e, f = 2, 16, cfg.d_model, cfg.n_experts, cfg.d_ff
    width = {"wq": d, "wk": d, "wv": d, "wo": d, "router": e,
             "experts": e * f}
    saved_ops = []
    policy = tl._save_policy

    def recording(save_dots, names, ctx, func, *args, **kwargs):
        out = policy(save_dots, names, ctx, func, *args, **kwargs)
        if out == tl.CheckpointPolicy.MUST_SAVE:
            saved_ops.append((func, (args[0].shape[0], args[1].shape[1])))
        return out

    monkeypatch.setattr(tl, "_save_policy", recording)
    one = {**params, "layers": {k: v[:1] for k, v in params["layers"].items()}}
    leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(one)]
    tl.loss_fn(tree_unflatten(one, leaves),
               {"tokens": torch.from_numpy(_tokens(b, t + 1) % 128)}, cfg)
    assert all(fn is torch.ops.aten.mm.default for fn, _ in saved_ops)
    assert sorted(shape for _, shape in saved_ops) == sorted(
        (b * t, width[n]) for n in saved)


@pytest.mark.parametrize("grads_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_tiny_trains(grads_dtype):
    """tests/test_moe.py::test_moe_tiny_trains on the port: eight fused
    AdamW steps of make_train_step per impl, from the same f32 masters;
    the loss falls by 10% and the capacity impl's (capacity factor 2)
    ends within 15% of the dense impl's."""
    losses = {}
    base = tl.LlamaConfig(**{**tl.llama2_size("moe-tiny").__dict__,
                             "dtype": "float32", "max_seq_len": 32,
                             "capacity_factor": 2.0})
    init = tl.init_params(base, torch.Generator().manual_seed(0),
                          device="cpu", master=True)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, base.vocab_size, (4, 33)))
    data = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    for impl in ("dense", "capacity"):
        cfg = tl.LlamaConfig(**{**base.__dict__, "moe_impl": impl})
        opt = fused_adamw(3e-3)
        state = init_train_state(lambda dev: tree_unflatten(
            init, [x.clone() for x in tree_leaves(init)]), opt, device="cpu")
        step = make_train_step(lambda p, b: tl.loss_fn(p, b, cfg), opt,
                               grads_dtype=grads_dtype, device="cpu")
        ls = []
        for _ in range(8):
            state, m = step(state, data)
            ls.append(float(m["loss"]))
        assert np.isfinite(ls).all() and np.isfinite(float(m["grad_norm"]))
        assert ls[-1] < ls[0] * 0.9, f"{impl}: loss did not decrease {ls}"
        losses[impl] = ls
    np.testing.assert_allclose(losses["capacity"][-1], losses["dense"][-1],
                               rtol=0.15)
