"""The port's sharded train step against the JAX package's, on gloo ranks.

One world of 8 CPU ranks (``launch.spawn``, gloo) runs every case of
``test_torch_dist_ranks.parallel_step_rank``; the JAX side runs in the
test process on the 8 host devices of tests/conftest.py, on the same
mesh layout, from the same init params (JAX's, converted) and tokens. Layouts: the five of
tests/test_parallel.py:31-37 on the dense tiny Llama, then ``dp=2,
ep=4`` (tests/test_moe.py:55) and the dry run's ``tp=2, sp=2, ep=2`` on
its MoE (4 experts, top-2, capacity routing).

Tolerances (f32): the loss rtol 2e-4 (tests/test_parallel.py:72; sums in
other orders over other splits); each gradient's relative L2 error 1e-4.
The sharded optimizer update is held bit for bit to the one-device
update on the same gradients (bf16 moments, the second by stochastic
rounding seeded with global element indices).
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
from ray_tpu.parallel import use_mesh as j_use_mesh
from ray_tpu.train import batch_sharding as j_batch_sharding
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.utils.trees import tree_paths

import test_torch_dist_ranks as ranks

LAYOUTS = [dict(dp=8), dict(fsdp=8), dict(fsdp=2, sp=2, tp=2),
           dict(dp=2, fsdp=2, tp=2), dict(fsdp=4, tp=2),
           dict(dp=2, ep=4), dict(tp=2, sp=2, ep=2)]
IDS = [MeshConfig(**lay).describe() for lay in LAYOUTS]
LOSS_RTOL = 2e-4
GRAD_REL_L2 = 1e-4


def _jax_cfg(layout):
    moe = dict(n_experts=4, top_k=2) if layout.get("ep", 1) > 1 else {}
    return jl.LlamaConfig.tiny(n_layers=2, remat=False, **moe)


def _jax_params(layout):
    return jax.tree_util.tree_map(np.asarray, jl.init_params(
        _jax_cfg(layout), jax.random.PRNGKey(0)))


def _jax_case(layout, params, tokens):
    """JAX's sharded loss and gradients at ``params``: the step's
    value_and_grad, jitted on the layout's mesh."""
    cfg = _jax_cfg(layout)
    mesh = j_build_mesh(JMeshConfig(**layout), jax.devices()[:8])
    batch = {"inputs": jnp.asarray(tokens[:, :-1]),
             "targets": jnp.asarray(tokens[:, 1:])}
    with j_use_mesh(mesh):
        params_sh = jax.device_put(params, j_shardings(
            jl.param_logical_axes(cfg), mesh))
        batch = jax.device_put(batch, j_batch_sharding(mesh))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jl.loss_fn(p, b, cfg), has_aux=True))(params_sh, batch)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def run():
    tokens = np.random.RandomState(7).randint(0, 256, (8, 33)).astype(np.int64)
    params = [_jax_params(lay) for lay in LAYOUTS]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # ranks meanwhile
        ranks_done = pool.submit(launch.spawn, ranks.parallel_step_rank, 8,
                                 LAYOUTS, params, tokens, device="cpu",
                                 timeout_s=400)
        jax_side = [_jax_case(lay, p, tokens) for lay, p in zip(LAYOUTS, params)]
        return jax_side, ranks_done.result()


def _case(outs, key, rank=0):
    res = outs[rank][key]
    assert "error" not in res, res["error"]
    return res


@pytest.mark.parametrize("i", range(len(LAYOUTS)), ids=IDS)
def test_sharded_loss_matches_jax(run, i):
    jax_side, outs = run
    losses = {_case(outs, IDS[i], r)["loss"] for r in range(8)}
    assert len(losses) == 1, f"ranks disagree: {losses}"
    np.testing.assert_allclose(losses.pop(), jax_side[i][0], rtol=LOSS_RTOL)
    res = _case(outs, IDS[i])
    assert res["step"] == 1
    assert res["metric_types"] == ["Tensor"]
    assert res["grad_placements_follow_params"]


@pytest.mark.parametrize("i", range(len(LAYOUTS)), ids=IDS)
def test_sharded_grads_match_jax(run, i):
    jax_side, outs = run
    got = _case(outs, IDS[i])["grads"]
    want = jax_side[i][1]
    paths = tree_paths(want)
    assert sorted(got) == sorted(paths)
    leaves = jax.tree_util.tree_leaves(want)
    errs = {p: float(np.linalg.norm(got[p] - w) / np.linalg.norm(w))
            for p, w in zip(paths, leaves)}
    assert max(errs.values()) <= GRAD_REL_L2, errs


@pytest.mark.parametrize("i", range(len(LAYOUTS)), ids=IDS)
def test_sharded_adamw_is_bit_exact(run, i):
    _, outs = run
    for r in range(8):
        res = _case(outs, IDS[i], r)["adamw"]
        assert res["nu_dtype"] == "torch.bfloat16"
        assert res["unequal"] == [], f"rank {r}: {res['unequal']}"


def test_fsdp8_params_are_sharded(run):
    # tests/test_parallel.py:76-80: wq [L, D, H*hd] splits D over fsdp
    res = _case(run[1], "fsdp=8")
    assert res["wq_local"][1] == res["wq_global"][1] // 8


def test_moment_shardings_follow_param_paths(run):
    # tests/test_parallel.py:82: wq and wo have one shape and transposed
    # shardings; each moment follows its own param
    res = _case(run[1], "moments")
    for name in ("wq", "wo"):
        assert res[name]["mu"] == res[name]["param"] == res[name]["nu"]
        assert res[name]["sharding"] == res[name]["param"]
    assert res["wq"]["param"] != res["wo"]["param"]


@pytest.mark.parametrize("key,ep,sp,tp", [("dp=2xep=4", 4, 1, 1),
                                           ("ep=2xsp=2xtp=2", 2, 2, 2)])
def test_ep_rank_runs_only_its_experts(run, key, ep, sp, tp):
    """Each MoE layer's expert products see E/ep experts of the weights
    (none gathered over ep), d_ff/tp of them, whole rows of the sequence,
    and the rank's own block of experts."""
    cfg = _jax_cfg({"ep": ep})
    e_local = cfg.n_experts // ep
    for r in range(8):
        seen = _case(run[1], key, r)["moe_local"]
        assert len(seen) == cfg.n_layers
        coord_ep = (r // (sp * tp)) % ep  # rank r's coordinate on ep
        for s in seen:
            assert s["w_gate"] == (e_local, cfg.d_model, cfg.d_ff // tp)
            assert s["w_down"] == (e_local, cfg.d_ff // tp, cfg.d_model)
            assert s["router"] == (cfg.d_model, cfg.n_experts)
            assert s["x"][1] == 32  # the whole sequence
            assert s["first"] == coord_ep * e_local


def test_pipeline_mesh_raises(run):
    # a pp mesh runs the GPipe pipeline (tests/test_torch_pipeline.py); a
    # batch that does not split into its microbatches raises JAX's error
    res = _case(run[1], "pipeline")
    assert res["raised"] == "batch=8 not divisible by microbatches=3"
