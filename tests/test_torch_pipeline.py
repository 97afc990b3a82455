"""The port's GPipe pipeline over pp against the JAX package's, on gloo ranks.

One world of 8 CPU ranks (``launch.spawn``, gloo) runs every case of
``test_torch_dist_ranks.pipeline_rank``; the JAX side runs in the test
process on the 8 host devices of tests/conftest.py, on the same meshes,
from the same inputs (seeded numpy; Llama params are JAX's init,
converted). The cases mirror tests/test_pipeline.py:

- ``pipeline_apply`` of an 8-layer tanh MLP of width 16 on pp=4, tp=2,
  4 microbatches: atol 2e-5 (tests/test_pipeline.py:55).
- Its gradients (of sum(out**2)) on dp=2, pp=4 with the params split
  over pp, at 2 microbatches and at 1 (M < S: every stage idles on
  S - 1 of its ticks): rtol 2e-4, atol 2e-5 (tests/test_pipeline.py:73).
- ``llama.forward`` on pp=4, fsdp=2 at ``pipeline_microbatches`` 2 and 0
  (auto: M = 4, which the 2 rows each rank holds do not split into):
  rtol 2e-4, atol 2e-4 (tests/test_pipeline.py:88).
- The train step on dp=1, pp=2, fsdp=2, tp=2 (remat on, 2
  microbatches): the step-1 loss against JAX's sharded loss (rtol 2e-4),
  the same on every rank; the moments placed as their params;
  every gradient at relative L2 <= 1e-4; the gradients of the leaves
  replicated over pp (embed, final_norm, lm_head) on EVERY rank against
  the port's one-device step at relative L2 <= 1e-4 (stage 0's share
  alone, or pp times the gradient, would miss); the loss falling over 6
  steps; the sharded FusedAdamW update bit-equal to the one-device one.
- The ValueErrors for a layer count that does not split over the stages
  and a batch that does not split into the microbatches.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel import logical_tree_to_shardings as j_shardings
from ray_tpu.parallel import pipeline_apply as j_pipeline_apply
from ray_tpu.parallel import use_mesh as j_use_mesh
from ray_tpu.train import batch_sharding as j_batch_sharding
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.utils.trees import tree_paths

import test_torch_dist_ranks as ranks

GRAD_MBS = {"m2": 2, "m1": 1}
LLAMA_MBS = {"mb2": 2, "mb0": 0}
STEP_LAYOUT = dict(dp=1, pp=2, fsdp=2, tp=2)
STEPS_AFTER = 5
GRAD_REL_L2 = 1e-4


def _mlp(n_layers, d, seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(n_layers, d, d) / np.sqrt(d)).astype(np.float32),
            "b": (rng.randn(n_layers, d) * 0.01).astype(np.float32)}


def _j_mlp_layer(h, p):
    return jnp.tanh(h @ p["w"] + p["b"])


def _jax_apply(params, x, layout, m):
    mesh = j_build_mesh(JMeshConfig(**layout), jax.devices()[:8])
    with j_use_mesh(mesh):
        return np.asarray(jax.jit(lambda p, h: j_pipeline_apply(
            _j_mlp_layer, p, h, num_microbatches=m))(params, x))


def _jax_grads(params, x, m):
    mesh = j_build_mesh(JMeshConfig(dp=2, pp=4), jax.devices()[:8])

    def loss(p, h):
        return jnp.sum(j_pipeline_apply(_j_mlp_layer, p, h, num_microbatches=m) ** 2)

    with j_use_mesh(mesh):
        g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return {"x": np.asarray(g_x), **{k: np.asarray(v) for k, v in g_p.items()}}


def _jax_llama_forward(params, tokens, mb):
    cfg = jl.LlamaConfig.tiny(n_layers=4, pipeline_microbatches=mb)
    mesh = j_build_mesh(JMeshConfig(pp=4, fsdp=2), jax.devices()[:8])
    with j_use_mesh(mesh):
        return np.asarray(jax.jit(lambda p, t: jl.forward(p, t, cfg))(
            params, jnp.asarray(tokens)))


def _jax_step(params, tokens):
    """JAX's sharded loss and gradients at ``params`` on STEP_LAYOUT."""
    cfg = jl.LlamaConfig.tiny(n_layers=2, pipeline_microbatches=2)
    mesh = j_build_mesh(JMeshConfig(**STEP_LAYOUT), jax.devices()[:8])
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:])}
    with j_use_mesh(mesh):
        params_sh = jax.device_put(params, j_shardings(
            jl.param_logical_axes(cfg), mesh))
        batch = jax.device_put(batch, j_batch_sharding(mesh))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jl.loss_fn(p, b, cfg), has_aux=True))(params_sh, batch)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _jax_llama_params(n_layers):
    cfg = jl.LlamaConfig.tiny(n_layers=n_layers)
    return jax.tree_util.tree_map(np.asarray, jl.init_params(
        cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def run():
    mlp = {"params": _mlp(8, 16, 0),
           "x": np.random.RandomState(1).randn(8, 16).astype(np.float32)}
    grad_params = _mlp(4, 8, 2)
    grad_x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    grad_cases = {k: (grad_params, grad_x, m) for k, m in GRAD_MBS.items()}
    fwd_params = _jax_llama_params(4)
    fwd_tokens = np.random.RandomState(4).randint(0, 256, (4, 16)).astype(np.int64)
    llama_cases = {k: (fwd_params, fwd_tokens, mb) for k, mb in LLAMA_MBS.items()}
    step_params = _jax_llama_params(2)
    step_tokens = np.random.RandomState(5).randint(0, 256, (4, 33)).astype(np.int64)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # ranks meanwhile
        done = pool.submit(launch.spawn, ranks.pipeline_rank, 8, mlp, grad_cases,
                           llama_cases, (STEP_LAYOUT, step_params, step_tokens,
                                         STEPS_AFTER),
                           device="cpu", timeout_s=400)
        want = {
            "apply": _jax_apply(mlp["params"], mlp["x"], dict(pp=4, tp=2), 4),
            "grads": {k: _jax_grads(grad_params, grad_x, m)
                      for k, m in GRAD_MBS.items()},
            "grad_outs": {k: _jax_apply(grad_params, grad_x, dict(dp=2, pp=4), m)
                          for k, m in GRAD_MBS.items()},
            "llama": {k: _jax_llama_forward(fwd_params, fwd_tokens, mb)
                      for k, mb in LLAMA_MBS.items()},
            "step": _jax_step(step_params, step_tokens),
        }
        return want, done.result()


def _case(outs, key, rank=0):
    res = outs[rank][key]
    assert "error" not in res, res["error"]
    return res


def test_pipeline_apply_matches_jax(run):
    want, outs = run
    for r in range(8):
        np.testing.assert_allclose(_case(outs, "apply", r)["out"], want["apply"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", list(GRAD_MBS))
def test_pipeline_grads_match_jax(run, name):
    want, outs = run
    for r in range(8):
        got = _case(outs, f"grads/{name}", r)
        np.testing.assert_allclose(got["out"], want["grad_outs"][name],
                                   rtol=2e-4, atol=2e-5)
        for k, w in want["grads"][name].items():
            np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {r}, d{k}")


@pytest.mark.parametrize("name", list(LLAMA_MBS))
def test_llama_forward_pipelined_matches_jax(run, name):
    want, outs = run
    np.testing.assert_allclose(_case(outs, f"llama/{name}")["logits"],
                               want["llama"][name], rtol=2e-4, atol=2e-4)


def test_pp_step_loss_matches_jax(run):
    want, outs = run
    losses = {_case(outs, "step", r)["loss"] for r in range(8)}
    assert len(losses) == 1, f"ranks disagree: {losses}"
    np.testing.assert_allclose(losses.pop(), want["step"][0], rtol=2e-4)
    res = _case(outs, "step")
    assert res["step"] == 1
    assert res["metric_types"] == ["Tensor"]
    assert res["grad_placements_follow_params"]
    assert res["moments_follow_params"]
    # wq [L=2, D, H]: one layer a stage, D split over fsdp, H over tp
    assert res["layers_local"] == (1, 32, 32)


def test_pp_step_grads_match_jax(run):
    want, outs = run
    got = _case(outs, "step")["grads"]
    grads = want["step"][1]
    paths = tree_paths(grads)
    assert sorted(got) == sorted(paths)
    errs = {p: float(np.linalg.norm(got[p] - w) / np.linalg.norm(w))
            for p, w in zip(paths, jax.tree_util.tree_leaves(grads))}
    assert max(errs.values()) <= GRAD_REL_L2, errs


def test_pp_replicated_leaf_grads_on_every_rank(run):
    _, outs = run
    for r in range(8):
        errs = _case(outs, "step", r)["replicated_rel_err"]
        assert max(errs.values()) <= GRAD_REL_L2, f"rank {r}: {errs}"


def test_pp_step_loss_falls(run):
    losses = _case(run[1], "step")["losses"]
    assert len(losses) == 1 + STEPS_AFTER
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_pp_sharded_adamw_is_bit_exact(run):
    for r in range(8):
        res = _case(run[1], "step", r)["adamw"]
        assert res["unequal"] == [], f"rank {r}: {res['unequal']}"


def test_pipeline_value_errors(run):
    assert _case(run[1], "errors")["raised"] == [
        "n_layers=3 not divisible by pp=2",
        "batch=6 not divisible by microbatches=4"]
