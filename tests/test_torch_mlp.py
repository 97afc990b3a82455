"""The port's MLP classifier against ray_tpu.models.mlp on the CPU.

The same numpy weights (JAX's init_params) and inputs through both
packages: logits at f32 atol=1e-5, the loss and the accuracy. The JAX
``loss_fn`` takes ``.mean()`` of ``softmax_cross_entropy``'s (loss,
n_tokens) pair and raises AttributeError, so the reference loss is
composed from JAX's own ``forward`` and ``softmax_cross_entropy``: the
mean cross-entropy that loss_fn means to return.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu.ops.losses import softmax_cross_entropy as j_xent
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.utils.trees import tree_leaves

CFGS = {"mnist": {}, "small": dict(d_in=20, d_hidden=16, n_hidden=3, d_out=5),
        "bf16": dict(d_in=20, d_hidden=16, n_hidden=1, d_out=5,
                     dtype="bfloat16")}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _both(name, batch=32, seed=0):
    jcfg = jmlp.MLPConfig(**CFGS[name])
    tcfg = tmlp.MLPConfig(**CFGS[name])
    jparams = jmlp.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jparams)
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, jcfg.d_in).astype(np.float32)
    y = rng.randint(0, jcfg.d_out, batch).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, x, y


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_loss_and_accuracy_match_jax(name):
    jcfg, jparams, tcfg, tparams, x, y = _both(name)
    logits = jax.jit(lambda p, x_: jmlp.forward(p, x_, jcfg))(
        jparams, jnp.asarray(x))
    got = tmlp.forward(tparams, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == logits.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                               **TOL[jcfg.dtype])
    loss, metrics = tmlp.loss_fn(
        tparams, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, tcfg)
    want_loss = float(j_xent(logits, jnp.asarray(y))[0])
    np.testing.assert_allclose(float(loss), want_loss, **TOL[jcfg.dtype])
    assert float(metrics["loss"]) == float(loss)
    want_acc = float((np.asarray(logits).argmax(-1) == y).mean())
    assert float(metrics["accuracy"]) == pytest.approx(want_acc)


def test_jax_loss_fn_raises_on_its_loss_pair():
    jcfg, jparams, _, _, x, y = _both("small")
    with pytest.raises(AttributeError, match="mean"):
        jmlp.loss_fn(jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jcfg)


def test_init_params_law_and_axes():
    cfg = tmlp.MLPConfig()
    p = tmlp.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.eval_shape(lambda: jmlp.init_params(
        jmlp.MLPConfig(), jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, p))
    assert [tuple(t.shape) for t in tree_leaves(p)] == [
        a.shape for a in jax.tree_util.tree_leaves(jp)]
    assert tmlp.param_logical_axes(cfg) == jmlp.param_logical_axes(
        jmlp.MLPConfig())
    assert abs(p["layer0"]["w"].std().item() * np.sqrt(784) - 1.0) < 0.02
    assert (p["layer2"]["b"] == 0).all()
    again = tmlp.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert torch.equal(p["layer1"]["w"], again["layer1"]["w"])


def test_a_few_sgd_steps_fit_a_batch():
    _, _, tcfg, tparams, x, y = _both("small", batch=16, seed=3)
    leaves = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
              for k, v in tparams.items()}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    first = None
    for _ in range(30):
        loss, m = tmlp.loss_fn(leaves, batch, tcfg)
        first = loss.item() if first is None else first
        grads = torch.autograd.grad(loss, [t for v in leaves.values()
                                           for t in v.values()])
        with torch.no_grad():
            for t, g in zip([t for v in leaves.values() for t in v.values()],
                            grads):
                t -= 0.5 * g
    assert loss.item() < 0.5 * first
