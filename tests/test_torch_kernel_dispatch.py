"""Which CUDA kernel a flash-attention call takes, decided on the host.

``kernel_variant`` picks by device, dtype and head_dim, for each of the
four kernels (forward, fused backward, dq, dkv): the Hopper kernels (TMA,
wgmma) for bf16 at head_dim 128, the mma.sync / FMA kernels for the
rest, the plain version on the CPU. These run without a
card: the choice is a pure function, the alignment check reads only
``data_ptr()``, and the entry-point table is checked against the CUDA
sources' text.
"""

import re

import pytest
import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.ops import flash_attention as fa


KERNELS = ["flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("device,dtype,head_dim,want", [
    ("cuda", torch.bfloat16, 128, "{k}_sm90"),
    ("cuda", torch.bfloat16, 64, "{k}"),
    ("cuda", torch.bfloat16, 32, "{k}"),
    ("cuda", torch.bfloat16, 16, "{k}"),
    ("cuda", torch.float32, 128, "{k}"),
    ("cuda", torch.float32, 64, "{k}"),
    ("cpu", torch.bfloat16, 128, None),
    ("cpu", torch.float32, 16, None),
])
def test_kernel_variant(kernel, device, dtype, head_dim, want):
    got = fa.kernel_variant(kernel, device, dtype, head_dim)
    assert got == (want.format(k=kernel) if want else None)


def test_kernel_variant_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        fa.kernel_variant("flash_fwd", "mps", torch.bfloat16, 128)


@pytest.mark.parametrize("kernel", KERNELS)
def test_every_variant_has_an_entry_point_in_its_library(kernel):
    for dtype in (torch.bfloat16, torch.float32):
        for d in fa.HEAD_DIMS:
            entry = fa.kernel_variant(kernel, "cuda", dtype, d)
            src = (_kernels.CSRC / f"{fa._LIBRARY[entry]}.cu").read_text()
            assert re.search(rf'extern "C" int {entry}\(', src), entry
    assert set(fa.launch_counts()) == set(fa._LIBRARY)


def test_sm90_entry_points_take_no_head_dim_or_dtype():
    q = torch.zeros(2, 4, 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 6, 128, dtype=torch.bfloat16)
    assert fa._dims(q, k, True, "flash_fwd_sm90") == [2, 4, 2, 8, 6, 1]
    assert fa._dims(q, k, False, "flash_fwd") == [2, 4, 2, 8, 6, 128, 1, 0]
    for entry in ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"):
        assert fa._dims(q, k, True, entry) == [2, 4, 2, 8, 6, 1]


def _shifted(shape, dtype, elements):
    """A contiguous tensor that starts `elements` past an aligned base."""
    n = 1
    for s in shape:
        n *= s
    base = torch.zeros(n + 16, dtype=dtype)
    return base[elements:elements + n].view(shape)


def test_tma_alignment_check_raises_on_misaligned_tensor():
    ok = _shifted((1, 2, 8, 128), torch.bfloat16, 0)
    bad = _shifted((1, 2, 8, 128), torch.bfloat16, 1)  # 2 bytes past
    assert ok.data_ptr() % fa.TMA_ALIGN == 0 and bad.is_contiguous()
    fa.check_tma_aligned("flash_fwd_sm90", [("q", ok), ("k", ok)])
    with pytest.raises(ValueError, match="k starts at .*not 16-byte aligned"):
        fa.check_tma_aligned("flash_fwd_sm90", [("q", ok), ("k", bad)])
    # 8 bf16 elements past the base is 16 bytes: aligned again
    fa.check_tma_aligned("flash_fwd_sm90",
                         [("q", _shifted((1, 2, 8, 128), torch.bfloat16, 8))])


def test_cpu_bf16_head_dim_128_takes_the_plain_versions():
    torch.manual_seed(0)
    q = torch.randn(1, 4, 16, 128).bfloat16()
    k = torch.randn(1, 2, 16, 128).bfloat16()
    v = torch.randn(1, 2, 16, 128).bfloat16()
    fa.reset_launch_count()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    do = torch.randn(q.shape).bfloat16()
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True)
    want = fa.flash_bwd_fused_plain(q, k, v, do, lse, delta, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(fa.launch_counts().values()) == {0}


def test_cpu_bf16_head_dim_128_split_route_takes_the_plain_versions():
    """The dq and dkv wrappers at bf16, head_dim 128 (the Hopper kernels'
    shape on the card) give their plain versions' values on the CPU and
    launch nothing."""
    torch.manual_seed(1)
    q = torch.randn(1, 4, 24, 128).bfloat16()
    k = torch.randn(1, 2, 40, 128).bfloat16()
    v = torch.randn(1, 2, 40, 128).bfloat16()
    do = torch.randn(q.shape).bfloat16()
    for causal in (True, False):
        out, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        delta = (do.float() * out.float()).sum(-1)
        fa.reset_launch_count()
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        assert set(fa.launch_counts().values()) == {0}
        assert torch.equal(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                     causal=causal))
        want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal=causal)
        assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
        assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
