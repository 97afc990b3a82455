"""The port's flash-attention forward on the CPU against the JAX kernel.

On CPU tensors ``flash_attention_fwd`` is the kernel's plain torch
version; it is held, for both ``out`` and ``lse``, against the Pallas
forward ``ray_tpu.ops.flash_attention._flash_fwd`` run in interpret mode
and against ``attention_reference``. The CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.

Tolerances: f32 atol=1e-5 (exp2 vs exp and other summation orders);
bf16 atol=2e-2 on out because both sides round p to bf16 before P.V and
an exp differing in its last f32 bit can round to the neighbouring bf16
value (one step is 2**-8 of an O(1) term).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import attention_reference as j_attention_reference
from ray_tpu.ops.flash_attention import _flash_fwd
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import attention, attention_reference

F32_ATOL = 1e-5
BF16_ATOL = 2e-2
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, hq, hkv, t, s, d, dtype, seed=0):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, hq, t, d), rng.randn(b, hkv, s, d),
            rng.randn(b, hkv, s, d)]
    arrs = [a.astype(np.float32) for a in arrs]
    jx = [jnp.asarray(a).astype(_JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal,block_q,dtype", [
    (2, 4, 4, 64, 64, 16, True, 64, "float32"),    # MHA causal
    (2, 4, 4, 64, 64, 16, False, 64, "float32"),   # MHA non-causal
    (2, 4, 2, 64, 64, 16, True, 64, "float32"),    # GQA causal
    (2, 4, 2, 64, 64, 16, False, 64, "float32"),   # GQA non-causal
    (1, 4, 2, 1, 64, 16, True, 1, "float32"),      # decode: T=1 against S=64
    (1, 2, 2, 64, 32, 16, True, 16, "float32"),    # T > S: empty rows
    (1, 4, 2, 48, 48, 32, True, 16, "float32"),    # T=48 with block 16
    (2, 4, 2, 64, 64, 16, True, 64, "bfloat16"),
])
def test_fwd_matches_pallas_interpret(b, hq, hkv, t, s, d, causal, block_q,
                                      dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(b, hq, hkv, t, s, d, dtype)
    out_j, lse_j = _flash_fwd(qj, kj, vj, causal=causal, block_q=block_q,
                              block_k=s, interpret=True)
    out_t, lse_t = fa.flash_attention_fwd(qt, kt, vt, causal=causal)
    assert out_t.dtype == _TDT[dtype] and out_t.shape == (b, hq, t, d)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (b, hq, t)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=atol)
    # lse is f32 on both sides whatever the input dtype; only rounding
    # of the f32 sums differs (values ~ log S + max logit ~ 10)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j, np.float32),
                               atol=1e-4, rtol=1e-5)
    # and the public layout agrees with the reference attention
    ref = attention_reference(qt.transpose(1, 2), kt.transpose(1, 2),
                              vt.transpose(1, 2), causal=causal)
    np.testing.assert_allclose(out_t.transpose(1, 2).float().numpy(),
                               ref.float().numpy(), atol=atol)


def test_empty_rows_are_zero_with_large_lse():
    (_, _, _), (qt, kt, vt) = _inputs(1, 2, 1, 40, 8, 16, "float32", seed=1)
    out, lse = fa.flash_attention_fwd(qt, kt, vt, causal=True)
    # rows 0..31 see no key (row i sees keys <= i + 8 - 40)
    assert torch.all(out[:, :, :32] == 0)
    assert torch.all(lse[:, :, :32] == 1e30)
    assert torch.isfinite(out[:, :, 32:]).all()
    assert torch.all(lse[:, :, 32:] < 1e29)


def test_public_layout_matches_jax_reference():
    (qj, kj, vj), (qt, kt, vt) = _inputs(2, 4, 2, 32, 32, 16, "float32",
                                         seed=2)
    got = fa.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                             vt.transpose(1, 2), causal=True)
    want = j_attention_reference(qj.transpose(0, 2, 1, 3),
                                 kj.transpose(0, 2, 1, 3),
                                 vj.transpose(0, 2, 1, 3), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_attention_on_cpu_launches_no_kernel():
    (_, _, _), (qt, kt, vt) = _inputs(1, 4, 2, 16, 16, 16, "float32")
    fa.reset_launch_count()
    out = attention(qt.transpose(1, 2), kt.transpose(1, 2),
                    vt.transpose(1, 2), causal=True)
    ref = attention(qt.transpose(1, 2), kt.transpose(1, 2),
                    vt.transpose(1, 2), causal=True, use_flash=False)
    assert fa.launch_count() == 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_ATOL)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from ray_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build(["flash_fwd"])
    assert not list(tmp_path.iterdir())
    # the library is keyed by the source: same source, same path
    assert _kernels.library_path("flash_fwd") == _kernels.library_path("flash_fwd")


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "gqa", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24),
                   torch.zeros(1, 2, 8, 24))
    elif bad == "gqa":
        k = v = torch.zeros(1, 3, 8, 16)
    else:
        v = torch.zeros(1, 2, 9, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, causal=True)
