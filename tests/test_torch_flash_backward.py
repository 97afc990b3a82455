"""The port's flash-attention backward on the CPU against the JAX kernels.

On CPU tensors the port's autograd op (``ops.flash_attention``) runs the
plain versions of the three backward kernels; dq, dk and dv are held
against ``jax.grad`` of ``ray_tpu.ops.flash_attention.flash_attention``
run in interpret mode (the Pallas backward kernels), on both sides of the
JAX gate between the fused kernel and the dq + dkv pair. The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``.

Tolerances: f32 atol=rtol=1e-4 (exp2 against exp, and sums in other
orders, over O(1) gradients). bf16 atol=rtol=4e-2: both sides round p
and ds to bf16 before their products, an f32 value that differs in its
last bit can round to the neighbouring bf16 value (one step is 2**-8 of
an O(1) term), and JAX also rounds its per-tile dq partials and
per-head dk/dv to bf16 before summing them where the port rounds once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _fused_blocks
from ray_tpu.ops.flash_attention import flash_attention as j_flash
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import attention, attention_reference

F32_TOL = 1e-4
BF16_TOL = 4e-2
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(b, t, s, hq, hkv, d, seed=0):
    """q, k, v and the output cotangent in the public layout [B, T, H, D]."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, t, hq, d))]


def _jax_grads(arrs, dtype, causal, block_q, block_k):
    q, k, v, do = [jnp.asarray(a).astype(_JDT[dtype]) for a in arrs]

    def f(q, k, v):
        out = j_flash(q, k, v, causal=causal, block_q=block_q,
                      block_k=block_k, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    return [np.asarray(g, np.float32)
            for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(arrs, dtype, causal, fn=None):
    q, k, v, do = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs]
    for x in (q, k, v):
        x.requires_grad_()
    fn = fn or (lambda q, k, v: fa.flash_attention(q, k, v, causal=causal))
    out = fn(q, k, v)
    out.backward(do)
    return [x.grad.float().numpy() for x in (q, k, v)]


CASES = [
    # b, t, s, hq, hkv, d, causal, block_q, block_k, dtype
    (2, 64, 64, 4, 4, 16, True, 64, 64, "float32"),     # MHA causal
    (2, 64, 64, 4, 4, 16, False, 64, 64, "float32"),    # MHA non-causal
    (2, 64, 64, 4, 2, 16, True, 64, 64, "float32"),     # GQA causal
    (2, 48, 48, 4, 1, 32, False, 16, 16, "float32"),    # GQA 4/1 non-causal
    (1, 1, 64, 4, 2, 16, True, 1, 64, "float32"),       # T=1 against S=64
    (1, 64, 32, 2, 2, 16, True, 16, 32, "float32"),     # T > S: empty rows
    (2, 64, 64, 4, 2, 16, True, 64, 64, "bfloat16"),
    # past the JAX gate: 9 key tiles of 512 -> the dq + dkv kernels
    (1, 128, 4608, 2, 1, 16, True, 128, 512, "float32"),
    # bf16 at head_dim 128, GQA, past both gates (17 key tiles of 512 in
    # JAX, S > 8192 in the port): the Hopper dq and dkv kernels' shape
    (1, 64, 8704, 4, 2, 128, True, 64, 512, "bfloat16"),
]


@pytest.mark.parametrize("b,t,s,hq,hkv,d,causal,block_q,block_k,dtype", CASES)
def test_backward_matches_pallas_interpret(b, t, s, hq, hkv, d, causal,
                                           block_q, block_k, dtype):
    legacy = s > 2048
    assert (_fused_blocks(t, s, block_q, block_k) is None) == legacy
    arrs = _arrays(b, t, s, hq, hkv, d)
    want = _jax_grads(arrs, dtype, causal, block_q, block_k)
    fa.reset_launch_count()
    got = _port_grads(arrs, dtype, causal)
    assert set(fa.launch_counts().values()) == {0}  # the CPU runs no kernel
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"d{name}")
    if t > s and causal:  # rows that see no key get dq = 0
        assert np.all(got[0][:, :t - s] == 0)


def test_gate_rule():
    assert fa._use_fused_bwd(2048, 2048)
    assert fa._use_fused_bwd(256, 8192)
    assert not fa._use_fused_bwd(256, 8193)
    assert not fa._use_fused_bwd(256, 16384)
    assert not fa._use_fused_bwd(1024, 12288)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_agree_with_autograd_of_reference(causal):
    """The three plain backward versions (the kernels' contracts) against
    each other and against autograd of the plain forward, f32."""
    b, t, s, hq, hkv, d = 1, 24, 40, 4, 2, 16
    q, k, v, do = [torch.from_numpy(a) for a in _arrays(b, t, s, hq, hkv, d, 3)]
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal)
    delta = (dot * out).sum(-1)
    dq, dk, dv = fa.flash_bwd_fused_plain(qt, kt, vt, dot, lse, delta,
                                          causal=causal)
    dq2 = fa.flash_bwd_dq_plain(qt, kt, vt, dot, lse, delta, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv_plain(qt, kt, vt, dot, lse, delta,
                                      causal=causal)
    for a, b_ in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b_)
    # the public wrappers take the plain versions for CPU tensors
    for a, b_ in zip(fa.flash_bwd_fused(qt, kt, vt, dot, lse, delta,
                                        causal=causal), (dq, dk, dv)):
        assert torch.equal(a, b_)
    want = _port_grads([x.numpy() for x in (q, k, v, do)], "float32", causal,
                       lambda q_, k_, v_: attention_reference(q_, k_, v_,
                                                              causal=causal))
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, atol=1e-5)


def test_attention_grads_equal_reference_under_autograd():
    arrs = _arrays(2, 32, 32, 4, 2, 16, seed=5)
    got = _port_grads(arrs, "float32", True,
                      lambda q, k, v: attention(q, k, v, causal=True,
                                                use_flash=None))
    want = _port_grads(arrs, "float32", True,
                       lambda q, k, v: attention_reference(q, k, v,
                                                           causal=True))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_backward_wrappers_reject_bad_residuals():
    q = torch.zeros(1, 2, 8, 16)
    k = v = torch.zeros(1, 1, 8, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_fused(q, k, v, q, lse.double(), lse, causal=True)
    with pytest.raises(ValueError, match="do"):
        fa.flash_bwd_dq(q, k, v, q[:, :, :4], lse, lse, causal=True)
