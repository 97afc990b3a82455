"""ray_tpu_torch.ops against ray_tpu.ops on the CPU.

The same seeded numpy inputs go through the JAX op and its port.
Tolerances: f32 atol=1e-5 (the two frameworks sum in different orders);
bf16 cases say why theirs is wider.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _repeat_kv as j_repeat_kv
from ray_tpu.ops.attention import attention_reference as j_attention_reference
from ray_tpu.ops import losses as jlosses
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops.attention import _repeat_kv as t_repeat_kv
from ray_tpu_torch.ops.attention import attention_reference as t_attention_reference
from ray_tpu_torch.ops import losses as tlosses
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope

F32_ATOL = 1e-5
# bf16 keeps 8 mantissa bits: one rounding step of an O(1) value is
# 2**-8 ~ 4e-3, and the two frameworks may round an intermediate at
# different places, so bf16 outputs may differ by a couple of steps.
BF16_ATOL = 2e-2

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(_JDT[dtype]), torch.from_numpy(a).to(_TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _atol(dtype):
    return F32_ATOL if dtype == "float32" else BF16_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.RandomState(0)
    xj, xt = _pair(rng.randn(3, 5, 64), dtype)
    w = rng.randn(64).astype(np.float32)
    got = tnorms.rms_norm(xt, torch.from_numpy(w), 1e-5)
    want = jnorms.rms_norm(xj, jnp.asarray(w), 1e-5)
    assert got.dtype == _TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=_atol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary(dtype):
    rng = np.random.RandomState(1)
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    sj, cj = jrope.rotary_embedding(jnp.asarray(pos), 32, 10000.0)
    st, ct = trope.rotary_embedding(torch.from_numpy(pos), 32, 10000.0)
    # angles reach ~500 rad: sin/cos of an f32 argument that large carry
    # ~500 * 2**-24 ~ 3e-5 of argument rounding
    np.testing.assert_allclose(_np(st), _np(sj), atol=1e-4)
    np.testing.assert_allclose(_np(ct), _np(cj), atol=1e-4)
    xj, xt = _pair(rng.randn(2, 7, 4, 32), dtype)
    got = trope.apply_rotary(xt, torch.from_numpy(_np(sj).copy()),
                             torch.from_numpy(_np(cj).copy()))
    want = jrope.apply_rotary(xj, sj, cj)
    assert got.dtype == _TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=_atol(dtype))


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy(masked):
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 6, 50).astype(np.float32) * 3
    labels = rng.randint(0, 50, size=(3, 6)).astype(np.int32)
    mask = (rng.rand(3, 6) > 0.4).astype(np.float32) if masked else None
    lt, nt = tlosses.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask))
    lj, nj = jlosses.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(lt), float(lj), atol=F32_ATOL)
    assert float(nt) == float(nj)


@pytest.mark.parametrize("b,t,s,hq,hkv,d,causal,dtype", [
    (2, 16, 16, 4, 4, 16, True, "float32"),     # MHA causal
    (2, 16, 16, 4, 2, 16, False, "float32"),    # GQA non-causal
    (1, 1, 24, 4, 1, 32, True, "float32"),      # decode row, group 4
    (1, 12, 8, 2, 2, 16, True, "float32"),      # T > S: empty rows
    (2, 16, 16, 4, 2, 32, True, "bfloat16"),
])
def test_attention_reference(b, t, s, hq, hkv, d, causal, dtype):
    rng = np.random.RandomState(3)
    qj, qt = _pair(rng.randn(b, t, hq, d), dtype)
    kj, kt = _pair(rng.randn(b, s, hkv, d), dtype)
    vj, vt = _pair(rng.randn(b, s, hkv, d), dtype)
    got = t_attention_reference(qt, kt, vt, causal=causal)
    want = j_attention_reference(qj, kj, vj, causal=causal)
    assert got.dtype == _TDT[dtype] and got.shape == (b, t, hq, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=_atol(dtype))


def test_repeat_kv():
    rng = np.random.RandomState(4)
    kj, kt = _pair(rng.randn(2, 5, 3, 8))
    np.testing.assert_array_equal(_np(t_repeat_kv(kt, 4)),
                                  _np(j_repeat_kv(kj, 4)))
