"""The port's mesh arithmetic and logical sharding rules against JAX's.

Pure functions, no process group: ``auto_mesh_config`` and
``_take_factor`` for n = 1..16 under every ``want_*``; the spec that
``logical_to_mesh_spec`` gives every leaf of ``param_logical_axes``
(dense and MoE) under the meshes of tests/test_parallel.py:31-37, equal
to JAX's ``PartitionSpec`` entry for entry; the placements DTensor gets
from a spec; ``shard_constraint`` outside a mesh. The meshes here are a
stand-in with a DeviceMesh's axis names and sizes. Then the device rules
of ``launch`` and the dry run: CUDA by default, and more ranks than cards
raise (nothing falls back to gloo or the CPU).
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import llama as jl
from ray_tpu.parallel import DEFAULT_RULES as J_RULES
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel import logical_to_mesh_spec as j_spec
from ray_tpu.parallel.mesh import _take_factor as j_take_factor
from ray_tpu.parallel.mesh import auto_mesh_config as j_auto
from ray_tpu_torch import multichip
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import launch, mesh as tmesh, sharding
from ray_tpu_torch.parallel.mesh import AXES, MeshConfig
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths

MESHES = [dict(dp=8), dict(fsdp=8), dict(fsdp=2, sp=2, tp=2),
          dict(dp=2, fsdp=2, tp=2), dict(fsdp=4, tp=2)]
WANTS = list(itertools.product((0, 1, 2, 3, 4), repeat=4))


class _Mesh:
    """A DeviceMesh's axis names and sizes, for the pure rule functions."""

    def __init__(self, **sizes):
        self.mesh_dim_names = AXES
        self._shape = MeshConfig(**sizes).shape

    def size(self, i):
        return self._shape[i]


@pytest.mark.parametrize("n", range(1, 17))
def test_auto_mesh_config_matches_jax(n):
    for tp, sp, ep, pp in WANTS:
        for prefer_fsdp in (True, False):
            kw = dict(want_tp=tp, want_sp=sp, want_ep=ep, want_pp=pp,
                      prefer_fsdp=prefer_fsdp)
            got, want = tmesh.auto_mesh_config(n, **kw), j_auto(n, **kw)
            assert got.shape == want.shape, kw
            assert got.size == want.size == n
            assert got.describe() == want.describe()


@pytest.mark.parametrize("n", range(1, 17))
def test_take_factor_matches_jax(n):
    assert [tmesh._take_factor(n, w) for w in range(20)] == \
        [j_take_factor(n, w) for w in range(20)]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("layout", MESHES, ids=lambda m: MeshConfig(**m).describe())
def test_param_specs_match_jax(layout, moe):
    kw = dict(n_experts=4, top_k=2) if moe else {}
    t_axes = tl.param_logical_axes(tl.LlamaConfig.tiny(**kw))
    j_axes = jl.param_logical_axes(jl.LlamaConfig.tiny(**kw))
    mesh = j_build_mesh(JMeshConfig(**layout), jax.devices()[:8])
    fake = _Mesh(**layout)
    def is_axes(x):
        return isinstance(x, tuple)

    j_leaves = jax.tree_util.tree_leaves(j_axes, is_leaf=is_axes)
    assert tree_paths(t_axes, is_leaf=is_axes) == \
        tree_paths(j_axes, is_leaf=is_axes)
    for path, t, j in zip(tree_paths(t_axes, is_leaf=is_axes),
                          tree_leaves(t_axes, is_leaf=is_axes), j_leaves):
        assert sharding.logical_to_mesh_spec(t, sharding.DEFAULT_RULES, fake) \
            == tuple(j_spec(j, J_RULES, mesh)), path
        assert sharding.logical_to_mesh_spec(t) == tuple(j_spec(j)), path


def test_logical_to_mesh_spec_dedup():
    # tests/test_parallel.py:22: fsdp, taken by batch, leaves embed
    # replicated; the trailing None is trimmed
    spec = sharding.logical_to_mesh_spec(("batch", "seq", "embed"))
    assert spec == (("dp", "fsdp"), "sp")
    assert spec == tuple(j_spec(("batch", "seq", "embed")))


def test_spec_to_placements():
    """DTensor placements live on the axes of size > 1, in mesh order;
    the batch, split over dp and fsdp, is Shard(0) on both."""
    fake = _Mesh(dp=2, fsdp=2, tp=2)
    assert tmesh.active_axes(fake) == ("dp", "fsdp", "tp")
    assert sharding.logical_to_placements(("batch", "seq", "embed"), fake) == \
        (Shard(0), Shard(0), Replicate())
    assert sharding.logical_to_placements(("layers", "embed", "heads"), fake) == \
        (Replicate(), Shard(1), Shard(2))
    one = _Mesh()
    assert tmesh.active_axes(one) == ("dp",)
    assert sharding.logical_to_placements(("batch", "seq"), one) == (Replicate(),)
    with pytest.raises(ValueError, match="no axis"):
        sharding.spec_to_placements(("nope",), fake)


def test_shard_constraint_is_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert sharding.shard_constraint(x, ("batch", "seq", "embed")) is x
    assert sharding.to_mesh(x, ("batch", "seq", "embed")) is x


def test_mesh_config_matches_jax():
    for layout in MESHES + [{}]:
        got, want = MeshConfig(**layout), JMeshConfig(**layout)
        assert (got.shape, got.size, got.describe()) == \
            (want.shape, want.size, want.describe())
    assert AXES == ("dp", "pp", "fsdp", "ep", "sp", "tp")


def test_world_of_one_builds_the_mesh():
    launch.init_process(0, 1, "cpu")
    try:
        mesh = tmesh.build_mesh(MeshConfig())
        assert mesh.mesh_dim_names == AXES and mesh.device_type == "cpu"
        assert tmesh.mesh_config(tmesh.local_mesh()) == MeshConfig()
        with pytest.raises(ValueError, match="ranks"):
            tmesh.build_mesh(MeshConfig(dp=2))
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(MeshConfig())


def test_ranks_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(print, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        launch.spawn(print, 2)
    with pytest.raises(RuntimeError, match="8 ranks need 8 CUDA devices"):
        multichip.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        launch.init_process(0, 2, store_path="unused")


@pytest.mark.parametrize("n,want", [
    (1, {}), (2, dict(tp=2)), (3, dict(dp=3)), (4, dict(sp=2, tp=2)),
    (6, dict(dp=3, tp=2)), (8, dict(ep=2, sp=2, tp=2)),
    (16, dict(fsdp=2, ep=2, sp=2, tp=2)), (24, dict(dp=3, ep=2, sp=2, tp=2))])
def test_dryrun_factors_as_jax(n, want):
    # __graft_entry__.py:138-153
    assert multichip.dryrun_mesh_config(n) == MeshConfig(**want)


def test_dryrun_batch_is_seeded():
    b = multichip.dryrun_batch(MeshConfig(dp=3), 256)
    assert b["inputs"].shape == (6, 32)
    np.testing.assert_array_equal(b["inputs"][:, 1:].numpy(),
                                  b["targets"][:, :-1].numpy())
