"""The port's fused AdamW against the JAX package's, on the CPU.

``_stochastic_round_bf16`` must give JAX's bits exactly. ``fused_adamw``
follows JAX's ``fused_adamw`` + ``optax.apply_updates`` for several steps
on the same seeded gradients: moments bit-exact (their arithmetic is the
same f32 multiply-adds, and the bf16 second moment is stochastically
rounded with the same dither), params within 1e-6 relative (the bias
corrections 1 - b**count are computed by numpy's f32 power here and by
XLA's there, which may differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.train.optim import _stochastic_round_bf16 as j_sr
from ray_tpu.train.optim import fused_adamw as j_fused_adamw
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import optim
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths

PARAM_RTOL = 1e-6


def _sr_input(n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 10.0 ** rng.randint(-6, 6, n)).astype(np.float32)
    bits = x.view(np.uint32)
    # a quarter of the values sit just below a bf16 step: the dither
    # carries into the kept half
    near = rng.rand(n) < 0.25
    bits[near] = (bits[near] & 0xFFFF0000) | rng.randint(0xFF00, 0x10000,
                                                         near.sum())
    x = bits.view(np.float32)
    x[:6] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, -3.0e38]
    return x


@pytest.mark.parametrize("shape,key", [
    ((7,), 0),
    ((3, 5, 17), 1),
    ((64, 33), 0xFFFFFFFF),
    ((1000,), 0x9E3779B9),
    ((2 ** 24 + 3,), 123456789),   # leaf size past 2**24
    ((2 ** 24 - 5,), 0xDEADBEEF),
])
def test_stochastic_round_bit_exact(shape, key):
    n = int(np.prod(shape))
    x = _sr_input(n, seed=n % 1000).reshape(shape)
    want = np.asarray(j_sr(jnp.asarray(x), jnp.uint32(key))).view(np.uint16)
    got = optim._stochastic_round_bf16(torch.from_numpy(x), key)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)


def _tree(seed):
    """Leaves inserted out of sorted order, so the seed index is JAX's
    sorted-key order and not insertion order."""
    rng = np.random.RandomState(seed)
    return {"z": rng.randn(4, 6).astype(np.float32),
            "a": {"y": rng.randn(5).astype(np.float32),
                  "b": rng.randn(3, 3).astype(np.float32)},
            "m": rng.randn(40).astype(np.float32)}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _linear(init, end, steps):
    def sched(count):
        frac = min(count, steps) / steps
        return init + (end - init) * frac
    return sched


@pytest.mark.parametrize("moments", ["f32", "bf16", "bf16_schedule"])
def test_fused_adamw_follows_jax(moments):
    mdt = None if moments == "f32" else (jnp.bfloat16, torch.bfloat16)
    j_kw = {} if mdt is None else dict(mu_dtype=mdt[0], nu_dtype=mdt[0])
    t_kw = {} if mdt is None else dict(mu_dtype=mdt[1], nu_dtype=mdt[1])
    if moments == "bf16_schedule":
        j_lr = optax.linear_schedule(1e-2, 1e-3, 4)
        t_lr = _linear(1e-2, 1e-3, 4)
    else:
        j_lr = t_lr = 3e-3
    j_opt = j_fused_adamw(j_lr, weight_decay=0.01, **j_kw)
    t_opt = optim.fused_adamw(t_lr, weight_decay=0.01, **t_kw)
    init = _tree(0)
    jp, tp = _to_jax(init), _to_torch(init)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for step in range(6):
        grads = _tree(100 + step)
        ju, js = j_opt.update(_to_jax(grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        ts = t_opt.update(_to_torch(grads), ts, tp)
    assert ts.count == int(js.count) == 6
    for path, j, t in zip(tree_paths(tp), jax.tree_util.tree_leaves(jp),
                          tree_leaves(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=PARAM_RTOL,
                                   atol=1e-9, err_msg=path)
    for j_tree, t_tree in ((js.mu, ts.mu), (js.nu, ts.nu)):
        for path, j, t in zip(tree_paths(t_tree),
                              jax.tree_util.tree_leaves(j_tree),
                              tree_leaves(t_tree)):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32),
                                          err_msg=path)


def test_leaf_order_is_jax_tree_flatten_order():
    """The stochastic-rounding seed of a leaf is its index in JAX's
    tree_flatten order; the port's walk of the Llama param tree gives the
    same order."""
    cfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0))
    j_paths = ["/".join(str(k.key) for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tparams = tl.init_params(tl.LlamaConfig.tiny(), device="cpu", master=True)
    assert tree_paths(tparams) == j_paths
    assert j_paths[:3] == ["embed", "final_norm", "layers/attn_norm"]
    assert j_paths[-1] == "lm_head"
    assert [t.shape for t in tree_leaves(tparams)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(jparams)]
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))
