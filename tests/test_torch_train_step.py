"""The port's single-device train step against the JAX package's, on the CPU.

A 3-step trajectory on ``LlamaConfig.tiny()`` (T=32): JAX
``make_train_step`` on a 1-device CPU mesh with ``use_flash=True`` (the
Pallas forward and backward kernels in interpret mode) and remat
``dots_flash_qkv_mlp``, against the port on the CPU with the same policy
(the plain versions of the kernels), from the same f32 master params and
the same tokens.

Tolerances. f32: losses and grad norms rtol=1e-5, params atol=1e-6
(sums in other orders), except in at most 0.1% of a leaf's elements,
and none by 3*lr: Adam's step m/(sqrt(v) + eps) turns a gradient near
eps = 1e-8 and an ulp of noise in it into a step that differs by a
fraction of lr. bf16 gradients:
losses rtol=1e-3, grad norms rtol=2e-2, params atol=2e-4: the bf16
params, activations and gradients round at other places in the two
frameworks (JAX fuses casts into its dots; the port's flash backward
rounds dq/dk/dv once where JAX rounds per tile and per head), 2**-8
relative per rounding, and the optimizer turns gradient differences into
update differences of up to lr * 2**-7.

Remat changes memory and time, never values: every policy gives the
gradients of ``remat=False``, and the attention forward runs once per
layer per step under a ``flash*`` policy, twice under "dots".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train import init_train_state as j_init_train_state
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu.train.optim import fused_adamw as j_fused_adamw
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.train import fused_adamw, init_train_state, make_train_step
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten

POLICY = "dots_flash_qkv_mlp"
POLICIES = ("dots", "dots_flash", "dots_flash_qkv", "dots_flash_qkv_mlp",
            "flash_qkv", "nothing")
LR = 1e-3
MAX_OUTLIERS = 1e-3  # share of a leaf's elements past the params tolerance
TOL = {"f32": dict(loss=1e-5, grad_norm=1e-5, params=1e-6),
       "bf16": dict(loss=1e-3, grad_norm=2e-2, params=2e-4)}


def _tokens(b=2, t=32, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t + 1)).astype(np.int32)


def _jax_run(grads_dtype, toks, steps=3):
    cfg = jl.LlamaConfig.tiny(use_flash=True, remat_policy=POLICY)
    mesh = build_mesh(MeshConfig(), jax.devices()[:1])
    opt = j_fused_adamw(LR, weight_decay=0.01)
    state, sh = j_init_train_state(
        lambda k: jl.init_params(cfg, k), jl.param_logical_axes(cfg), opt,
        mesh, key=jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, state.params)
    step = j_make_train_step(lambda p, b: jl.loss_fn(p, b, cfg), opt, mesh,
                             sh, donate_state=False, grads_dtype=grads_dtype)
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree_util.tree_map(np.asarray, state.params)


def _port_run(init, grads_dtype, toks, steps=3):
    cfg = tl.LlamaConfig.tiny(use_flash=True, remat_policy=POLICY)
    opt = fused_adamw(LR, weight_decay=0.01)
    state = init_train_state(
        lambda dev: tl.from_jax_params(init, cfg, dev, master=True), opt,
        device="cpu")
    step = make_train_step(lambda p, b: tl.loss_fn(p, b, cfg), opt,
                           grads_dtype=grads_dtype, device="cpu")
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == steps and state.opt_state.count == steps
    return metrics, state.params


@pytest.mark.parametrize("grads", ["f32", "bf16"])
def test_three_step_trajectory_matches_jax(grads):
    toks = _tokens()
    j_dt, t_dt = (None, None) if grads == "f32" else (jnp.bfloat16,
                                                      torch.bfloat16)
    init, j_metrics, j_params = _jax_run(j_dt, toks)
    t_metrics, t_params = _port_run(init, t_dt, toks)
    tol = TOL[grads]
    for jm, tm in zip(j_metrics, t_metrics):
        assert tm["tokens"] == jm["tokens"]
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=tol["loss"])
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=tol["grad_norm"])
    assert t_metrics[-1]["loss"] < t_metrics[0]["loss"]
    for path, t, j in zip(tree_paths(t_params), tree_leaves(t_params),
                          jax.tree_util.tree_leaves(j_params)):
        assert t.dtype == torch.float32
        err = np.abs(t.numpy() - j)
        # Adam divides by sqrt(v) + eps: where |g| is near eps (1e-8) an
        # ulp of gradient noise moves the step by a fraction of lr, so a
        # few elements may exceed the tolerance, never 3 steps of lr
        assert (err > tol["params"]).mean() <= MAX_OUTLIERS, path
        assert err.max() <= 3 * LR, path


def _grads(cfg, params, toks):
    leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(params)]
    loss, _ = tl.loss_fn(tree_unflatten(params, leaves),
                         {"tokens": torch.from_numpy(toks)}, cfg)
    return torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def tiny_params():
    return tl.init_params(tl.LlamaConfig.tiny(), torch.Generator().manual_seed(1),
                          device="cpu", master=True)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_changes_no_gradient(policy, tiny_params):
    toks = _tokens(seed=2)
    want = _grads(tl.LlamaConfig.tiny(remat=False), tiny_params, toks)
    got = _grads(tl.LlamaConfig.tiny(remat_policy=policy), tiny_params, toks)
    for path, g, w in zip(tree_paths(tiny_params), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=path)


def test_unknown_policy_raises_the_reference_error(tiny_params):
    toks = _tokens(seed=3)
    with pytest.raises(ValueError) as j_err:
        jcfg = jl.LlamaConfig.tiny(remat_policy="everything")
        jax.grad(lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(toks)},
                                      jcfg)[0])(
            jl.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError) as t_err:
        _grads(tl.LlamaConfig.tiny(remat_policy="everything"), tiny_params,
               toks)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("policy,per_layer", [
    ("dots_flash_qkv_mlp", 1), ("dots_flash", 1), ("flash_qkv", 1),
    ("dots", 2), ("nothing", 2)])
def test_attention_forward_runs_per_policy(policy, per_layer, monkeypatch,
                                           tiny_params):
    calls = []
    plain = fa.flash_attention_fwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_fwd_plain", counted)
    cfg = tl.LlamaConfig.tiny(remat_policy=policy)
    opt = fused_adamw(LR)
    state = init_train_state(  # the step updates its params in place
        lambda dev: tree_unflatten(tiny_params, [x.clone() for x in
                                                 tree_leaves(tiny_params)]),
        opt, device="cpu")
    step = make_train_step(lambda p, b: tl.loss_fn(p, b, cfg), opt,
                           grads_dtype=torch.bfloat16, device="cpu")
    for n in (1, 2):
        state, _ = step(state, {"tokens": torch.from_numpy(_tokens(seed=4))})
        assert len(calls) == n * per_layer * cfg.n_layers
