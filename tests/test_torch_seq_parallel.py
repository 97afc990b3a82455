"""Ring and Ulysses attention against the JAX package's, on gloo ranks.

JAX runs its ``ring_attention`` on an 8-device sp mesh
(tests/test_ring_attention.py:34-83) and its ``ulysses_attention`` on
the meshes of tests/test_ulysses.py:29-56 (sp=4 x tp=2, and sp=8 with
gradients); the port runs in 8 gloo ranks (``launch.spawn``), each rank
with its block of the sequence (rank r's sp coordinate picks it), and
returns its rows of the output (and of the gradients). Tolerances, f32:
outputs atol 1e-5 (the same online-softmax recurrence, or the same
attention after the exchange, summed in other orders); gradients
relative L2 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.ops.ring_attention import ring_attention as j_ring
from ray_tpu.ops.ulysses import ulysses_attention as j_ulysses
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel import use_mesh as j_use_mesh
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.ulysses import ulysses_attention
from ray_tpu_torch.parallel import launch

import test_torch_dist_ranks as ranks

ATOL = 1e-5
GRAD_REL_L2 = 1e-4


def _qkv(b, t, h, d, hkv=None, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, t, h, d).astype(np.float32),
            rs.randn(b, t, hkv or h, d).astype(np.float32),
            rs.randn(b, t, hkv or h, d).astype(np.float32))


# name -> (q, k, v, causal, grad); ring runs on sp = 8
RING = {
    "causal": (*_qkv(2, 64, 2, 16), True, False),
    "noncausal": (*_qkv(2, 64, 2, 16, seed=1), False, False),
    "gqa": (*_qkv(1, 64, 4, 16, hkv=2, seed=2), True, False),
    "seq8k": (*_qkv(1, 8192, 1, 8, seed=3), True, False),
    "grads": (*_qkv(1, 64, 2, 16, seed=4), True, True),
}
# name -> (mesh layout, q, k, v, causal, grad)
ULYSSES = {
    "sp4_tp2_causal": (dict(sp=4, tp=2), *_qkv(2, 64, 8, 16), True, False),
    "sp4_tp2_noncausal": (dict(sp=4, tp=2), *_qkv(2, 64, 8, 16, seed=5), False,
                          False),
    "sp8_grads": (dict(sp=8), *_qkv(2, 32, 8, 16, seed=6), True, True),
}


def _jax_ring(q, k, v, causal, grad):
    mesh = Mesh(np.array(jax.devices()[:8]), ("sp",))
    sh = NamedSharding(mesh, P(None, "sp", None, None))
    args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v)]
    out = np.asarray(j_ring(*args, mesh, causal=causal))
    grads = None
    if grad:
        grads = jax.jit(jax.grad(lambda *a: j_ring(*a, mesh, causal=causal).sum(),
                                 argnums=(0, 1, 2)))(*args)
    return out, grads


def _jax_ulysses(layout, q, k, v, causal, grad):
    mesh = j_build_mesh(JMeshConfig(**layout), jax.devices()[:8])
    args = [jnp.asarray(a) for a in (q, k, v)]
    with j_use_mesh(mesh):
        out = np.asarray(jax.jit(lambda *a: j_ulysses(*a, causal=causal))(*args))
        grads = None
        if grad:
            grads = jax.jit(jax.grad(
                lambda *a: jnp.sum(j_ulysses(*a, causal=causal) ** 2),
                argnums=(0, 1, 2)))(*args)
    return out, grads


@pytest.fixture(scope="module")
def run():
    want = {f"ring/{n}": _jax_ring(*c) for n, c in RING.items()}
    want.update({f"ulysses/{n}": _jax_ulysses(*c) for n, c in ULYSSES.items()})
    outs = launch.spawn(ranks.seq_parallel_rank, 8, RING, ULYSSES,
                        device="cpu", timeout_s=300)
    return want, outs


def _rows(x, n, i):
    t = x.shape[1] // n
    return np.asarray(x)[:, i * t:(i + 1) * t]


def _check(want, outs, key, sp_of_rank):
    out, grads = want[key]
    for r in range(8):
        got = outs[r][key]
        assert "error" not in got, got["error"]
        sp, i = sp_of_rank(r, got)
        np.testing.assert_allclose(got["out"], _rows(out, sp, i), atol=ATOL,
                                   rtol=0)
        if grads is not None:
            for g, w in zip(got["grads"], grads):
                w = _rows(w, sp, i)
                assert np.linalg.norm(g - w) / np.linalg.norm(w) <= GRAD_REL_L2


@pytest.mark.parametrize("name", RING)
def test_ring_matches_jax(run, name):
    _check(*run, f"ring/{name}", lambda r, got: (8, r))


@pytest.mark.parametrize("name", ULYSSES)
def test_ulysses_matches_jax(run, name):
    sp = ULYSSES[name][0]["sp"]
    _check(*run, f"ulysses/{name}", lambda r, got: (sp, got["sp_index"]))


def test_ulysses_rejects_indivisible_heads(run):
    got = run[1][0]["ulysses/indivisible_heads"]
    assert got["raised"] and "not divisible" in got["raised"]


def test_ulysses_without_sp_is_attention():
    """No mesh (or sp = 1): the plain attention path, as JAX's fallback."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 32, 8, 16))
    got = ulysses_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, attention(q, k, v, causal=True),
                               rtol=0, atol=0)
    want = np.asarray(j_ulysses(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                                causal=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
