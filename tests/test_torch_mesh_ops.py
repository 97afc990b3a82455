"""The port's mesh collectives against the JAX package's, on gloo ranks.

The mesh of tests/test_collective.py:226-270: 8 devices as (4, 2), axes
("x", "y"). Every device holds its block of a global [16, 8] array of
integer-valued f32 under P("x", "y"), and JAX's op runs on it inside
``shard_map`` (its bare, ``wrap=False`` form), for each op, axis and
option; the port's op runs in 8 gloo ranks (``launch.spawn``), rank r at
mesh position (r // 2, r % 2), each on its block. Sums of integers are
exact in f32 and mean divides by a power of two, so every output, and
the gradients of ppermute and all-to-all (sum(out * w) against JAX's
``jax.grad``), must be bit-equal.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.collective import mesh_ops as jops
from ray_tpu_torch.parallel import launch

import test_torch_dist_ranks as ranks

SPEC = P("x", "y")
# (name, op, axis, kwargs)
CASES = [
    *[(f"allreduce_{op}_{ax}", "mesh_allreduce", ax, {"op": op})
      for op in ("sum", "max", "min", "mean") for ax in ("x", "y")],
    ("allgather_x_0", "mesh_allgather", "x", {"tiled_axis": 0}),
    ("allgather_y_1", "mesh_allgather", "y", {"tiled_axis": 1}),
    ("reducescatter_x_0", "mesh_reducescatter", "x", {"scatter_axis": 0}),
    ("reducescatter_y_1", "mesh_reducescatter", "y", {"scatter_axis": 1}),
    ("broadcast_x_root1", "mesh_broadcast", "x", {"root": 1}),
    ("broadcast_y_root0", "mesh_broadcast", "y", {"root": 0}),
    ("ppermute_x_1", "mesh_ppermute", "x", {"shift": 1}),
    ("ppermute_x_minus1", "mesh_ppermute", "x", {"shift": -1}),
    ("ppermute_x_3", "mesh_ppermute", "x", {"shift": 3}),
    ("ppermute_y_1", "mesh_ppermute", "y", {"shift": 1}),
    ("all_to_all_x", "mesh_all_to_all", "x", {"split_axis": 1, "concat_axis": 0}),
    ("all_to_all_y", "mesh_all_to_all", "y", {"split_axis": 0, "concat_axis": 1}),
]
DIFFERENTIABLE = ("mesh_ppermute", "mesh_all_to_all")


def _jax_fn(mesh, op, axis, kw):
    fn = getattr(jops, op)
    return jax.jit(jax.shard_map(lambda v: fn(v, mesh, axis, wrap=False, **kw),
                                 mesh=mesh, in_specs=SPEC, out_specs=SPEC,
                                 check_vma=False))


def _blocks(x):
    """Device (i, j)'s block of a global array under P("x", "y"), by rank."""
    return [ranks._block(x, (r // 2, r % 2), (4, 2)) for r in range(8)]


@pytest.fixture(scope="module")
def run():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    rs = np.random.RandomState(3)
    inputs, weights, want = {}, {}, {}
    for name, op, axis, kw in CASES:
        x = rs.randint(-50, 50, (16, 8)).astype(np.float32)
        inputs[name] = x
        f = _jax_fn(mesh, op, axis, kw)
        y = np.asarray(f(x))
        want[name] = {"out": _blocks(y)}
        if op in DIFFERENTIABLE:
            w = rs.randint(-5, 5, y.shape).astype(np.float32)
            weights[name] = w
            g = jax.grad(lambda v: (f(v) * w).sum())(x)
            want[name]["grad"] = _blocks(np.asarray(g))
    outs = launch.spawn(ranks.mesh_ops_rank, 8, CASES, inputs, weights,
                        device="cpu", timeout_s=300)
    return want, outs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_op_matches_jax(run, case):
    want, outs = run
    name, op = case[0], case[1]
    for r in range(8):
        got = outs[r][name]
        assert "error" not in got, got["error"]
        np.testing.assert_array_equal(got["out"], want[name]["out"][r])
        if op in DIFFERENTIABLE:
            np.testing.assert_array_equal(got["grad"], want[name]["grad"][r])
            np.testing.assert_array_equal(got["bare"], want[name]["out"][r])
