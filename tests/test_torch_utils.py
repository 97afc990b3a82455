"""The port's ``utils`` against the JAX package's.

- ``ray_tpu_torch.utils`` exports every name ``ray_tpu.utils`` exports,
  and ``cdiv`` / ``round_up_to_multiple`` agree on a grid.
- On one nested dict/list tree drawn from numpy seed 0 (f32, bf16 and
  int32 leaves), carried across as JAX arrays and torch tensors:
  ``tree_num_params``, ``tree_size_bytes``, the slash names of
  ``path_name`` (the port's paths are tuples of keys and indices) and
  ``tree_map_with_path_names`` equal JAX's.
- The tiny serving model's weight tree (``serve.llm.build_model("tiny")``
  at ``max_len`` 96 and 128) has ``tree_size_bytes`` 427264 in both
  packages: the ``weight_bytes`` that ``RUNTIME_BENCH.json`` records for
  the publish-to-adoption records.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.utils as jutils
from ray_tpu.serve import llm as jllm
from ray_tpu.utils import trees as jtrees
from ray_tpu_torch import utils
from ray_tpu_torch.serve import llm
from ray_tpu_torch.utils import trees

ROOT = pathlib.Path(__file__).resolve().parent.parent
PUBLIC = ("cdiv", "round_up_to_multiple", "tree_size_bytes",
          "tree_num_params", "tree_map_with_path_names")


def _numpy_tree():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "embed": f32(7, 5),
        "layers": [
            {"wq": f32(5, 3), "norm": ("bf16", f32(5)),
             "ids": rng.integers(0, 100, (4,), dtype=np.int32)},
            {"wq": f32(5, 3), "norm": ("bf16", f32(5)),
             "ids": rng.integers(0, 100, (2, 3), dtype=np.int32)},
        ],
        "head": {"b": ("bf16", f32(2, 2)), "a": f32(3)},
    }


def _carry(node, leaf):
    """The numpy tree with each leaf made by ``leaf(array, is_bf16)``."""
    if isinstance(node, tuple) and node and node[0] == "bf16":
        return leaf(node[1], True)
    if isinstance(node, dict):
        return {k: _carry(v, leaf) for k, v in node.items()}
    if isinstance(node, list):
        return [_carry(v, leaf) for v in node]
    return leaf(node, False)


def _jax_tree():
    return _carry(_numpy_tree(), lambda a, bf: jnp.asarray(
        a, jnp.bfloat16 if bf else a.dtype))


def _torch_tree():
    return _carry(_numpy_tree(), lambda a, bf: torch.from_numpy(a).to(
        torch.bfloat16) if bf else torch.from_numpy(a))


def test_exports_match_jax():
    for name in PUBLIC:
        assert hasattr(jutils, name)
        assert callable(getattr(utils, name)), name
    for a in range(0, 40):
        for b in (1, 2, 3, 8, 128):
            assert utils.cdiv(a, b) == jutils.cdiv(a, b)
            assert utils.round_up_to_multiple(a, b) == \
                jutils.round_up_to_multiple(a, b)


def test_counts_and_bytes_match_jax():
    jt, pt = _jax_tree(), _torch_tree()
    assert trees.tree_num_params(pt) == jtrees.tree_num_params(jt) == 92
    assert trees.tree_size_bytes(pt) == jtrees.tree_size_bytes(jt)
    # numpy leaves count the same as tensors
    np_tree = _carry(_numpy_tree(), lambda a, bf: a)
    assert trees.tree_num_params(np_tree) == jtrees.tree_num_params(jt)
    # by hand: 2 bytes a bf16 element, 4 an f32 or int32 one
    bf16 = 5 + 5 + 4
    assert utils.tree_size_bytes(pt) == 2 * bf16 + 4 * (92 - bf16)


def test_path_names_match_jax():
    jt, pt = _jax_tree(), _torch_tree()
    jax_paths, _ = jax.tree_util.tree_flatten_with_path(jt)
    want = [jtrees.path_name(p) for p, _ in jax_paths]
    got = [trees.path_name(p) for p, _ in trees._path_leaves(pt)]
    assert got == want
    assert "layers/1/ids" in got and "head/b" in got


def test_map_with_path_names_matches_jax():
    jt, pt = _jax_tree(), _torch_tree()
    jmapped = jtrees.tree_map_with_path_names(
        lambda n, x: f"{n}:{x.size}", jt)
    pmapped = utils.tree_map_with_path_names(
        lambda n, x: f"{n}:{x.numel()}", pt)
    assert jax.tree_util.tree_leaves(jmapped) == \
        [x for _, x in trees._path_leaves(pmapped)]
    assert isinstance(pmapped["layers"], list)
    assert pmapped["head"]["b"] == "head/b:4"


def _recorded_weight_bytes():
    rec = json.loads((ROOT / "RUNTIME_BENCH.json").read_text())["results"]
    return {r["weight_bytes"] for r in rec if "weight_bytes" in r}


@pytest.mark.parametrize("max_len", [96, 128])
def test_tiny_serving_tree_bytes_match_jax(max_len):
    params, _ = llm.build_model("tiny", max_len=max_len, seed=1, device="cpu")
    jparams, _ = jllm.build_model("tiny", max_len=max_len, seed=1)
    assert _recorded_weight_bytes() == {427264}
    assert trees.tree_size_bytes(params) == jtrees.tree_size_bytes(jparams) \
        == 427264
    assert trees.tree_num_params(params) == jtrees.tree_num_params(jparams)
