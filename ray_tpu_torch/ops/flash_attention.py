"""Flash attention: the CUDA kernels (csrc/flash_fwd*.cu, csrc/flash_bwd*.cu),
their plain torch versions, and the autograd op that joins them.

For a CUDA tensor each wrapper launches its kernel or raises; a CPU
tensor takes the plain version of the same contract. Each of the four
kernels (forward, fused backward, dq, dkv) has two CUDA variants, chosen
by shape and dtype in ``kernel_variant``: bf16 at head_dim 128 (every
main path) takes the Hopper kernels of csrc/flash_fwd_sm90.cu,
csrc/flash_bwd_sm90.cu (fused and dkv) and csrc/flash_bwd_dq_sm90.cu
(TMA, wgmma, warp specialisation); f32 and head_dim 16/32/64 take the
mma.sync and FMA kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu. The
contract:

  forward: q [B, Hq, T, D], k/v [B, Hkv, S, D] -> out [B, Hq, T, D] in
  q's dtype, lse [B, Hq, T] f32 (natural log). Scale d^-1/2, softmax
  statistics in f32, probabilities cast to v's dtype before P.V (f32
  accumulation), end-aligned causal mask (row i sees keys <= i + S - T),
  rows that see no key give out = 0 and lse = +1e30. GQA: head h reads
  kv head h // (Hq / Hkv).

  backward: (q, k, v, do, lse, delta = rowsum(do * out)) -> dq, dk, dv in
  the input dtype. p = exp(s - lse) is recomputed from the saved lse; p
  is cast to do's dtype before p^T.do and ds = p * (dp - delta) * scale
  to the input dtype before ds^T.q and ds.k; sums in f32, dk/dv summed
  over the GQA group, each output rounded once.

The backward has two routes, as in the JAX package: one fused kernel
(dq, dk, dv in one visit of each tile pair, dq added in f32) and, for
long key sequences, a dq kernel and a dkv kernel (``_use_fused_bwd``).

``torch.ops.ray_tpu_torch.flash_fwd`` is a registered op (the dispatcher
sees it, where a ctypes call inside an autograd.Function would be
invisible) whose autograd runs the backward kernels, so selective
activation checkpointing can save its (out, lse) by name and skip the
forward in the backward pass.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.utils.checkpoint_names import checkpoint_name
from ray_tpu_torch.utils.math import cdiv

HEAD_DIMS = (16, 32, 64, 128)
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
# The reference's default key block and its limit on the fused backward's
# dq partials (ray_tpu/ops/flash_attention.py:532-549).
_BLOCK_K = 1024
_MAX_K_TILES = 8

# Every C entry point, by the library (csrc/<library>.cu) that holds it.
_LIBRARY = {"flash_fwd": "flash_fwd", "flash_fwd_sm90": "flash_fwd_sm90",
            "flash_bwd_fused": "flash_bwd",
            "flash_bwd_fused_sm90": "flash_bwd_sm90",
            "flash_bwd_dq": "flash_bwd", "flash_bwd_dq_sm90": "flash_bwd_dq_sm90",
            "flash_bwd_dkv": "flash_bwd", "flash_bwd_dkv_sm90": "flash_bwd_sm90"}
# The Hopper variants take bf16 at this head_dim only.
SM90_HEAD_DIM = 128
# TMA reads tensors from 16-byte aligned addresses only.
TMA_ALIGN = 16

_launches = {name: 0 for name in _LIBRARY}
# stage threads of an MPMD pipeline, and the autograd engine's device
# thread, launch side by side
_launches_lock = threading.Lock()


def launch_count() -> int:
    """How many times a forward CUDA kernel (either variant) has been
    launched."""
    return _launches["flash_fwd"] + _launches["flash_fwd_sm90"]


def launch_counts() -> dict:
    """Launches of every flash kernel in this process, by kernel name."""
    return dict(_launches)


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    for name in _launches:
        _launches[name] = 0


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _causal_live(t, s, device):
    return torch.ones((t, s), dtype=torch.bool, device=device).tril(diagonal=s - t)


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True):
    """Plain torch forward with the kernel's contract (see module doc)."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1)
    sc = torch.matmul(q.float(), kk.transpose(-1, -2)) * (d ** -0.5)
    if causal:
        sc = sc.masked_fill(~_causal_live(t, s, q.device), _NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG_INF * 0.5, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = torch.matmul(p.to(v.dtype).float(), vv.float())
    out = (pv / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, -_NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def _bwd_plain(q, k, v, do, lse, delta, causal, want_dq, want_dkv):
    """The backward's arithmetic in plain torch, one kv head at a time (so
    the [B, group, T, S] f32 intermediates stay small): returns (dq, dk,
    dv), with None for what is not wanted."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    live = _causal_live(t, s, q.device) if causal else None
    dq = torch.empty_like(q) if want_dq else None
    dk = torch.empty_like(k) if want_dkv else None
    dv = torch.empty_like(v) if want_dkv else None
    for j in range(hkv):
        hs = slice(j * group, (j + 1) * group)
        qj, doj = q[:, hs].float(), do[:, hs]  # [B, G, T, D]
        kj, vj = k[:, j:j + 1], v[:, j:j + 1]  # [B, 1, S, D]
        sc = torch.matmul(qj, kj.float().transpose(-1, -2))  # [B, G, T, S]
        p = torch.exp2(sc * (scale * _LOG2E) - lse[:, hs, :, None] * _LOG2E)
        if live is not None:
            p = p.masked_fill(~live, 0.0)
        dp = torch.matmul(doj.float(), vj.float().transpose(-1, -2))
        ds = (p * (dp - delta[:, hs, :, None]) * scale).to(q.dtype).float()
        if want_dq:
            dq[:, hs] = torch.matmul(ds, kj.float()).to(q.dtype)
        if want_dkv:
            pt = p.to(do.dtype).float().transpose(-1, -2)  # [B, G, S, T]
            dv[:, j] = torch.matmul(pt, doj.float()).sum(dim=1).to(v.dtype)
            dk[:, j] = torch.matmul(ds.transpose(-1, -2), qj).sum(dim=1).to(k.dtype)
    return dq, dk, dv


def flash_bwd_fused_plain(q, k, v, do, lse, delta, *, causal: bool = True):
    """Plain version of ``flash_bwd_fused``: (dq, dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, True, True)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True):
    """Plain version of ``flash_bwd_dq``: dq."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, True, False)[0]


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True):
    """Plain version of ``flash_bwd_dkv``: (dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, delta, causal, False, True)[1:]


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check(q, k, v, *extra, what="flash_attention"):
    for name, x in (("q", q), ("k", k), ("v", v)) + extra:
        if x.dim() != 4:
            raise ValueError(f"{what}: {name} must be 4-D [B, H, T, D], got "
                             f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: dtype {q.dtype} not supported (bfloat16 "
                         "or float32)")
    b, hq, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hq % k.shape[1]:
        raise ValueError(f"{what}: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {HEAD_DIMS}")
    if t == 0 or k.shape[2] == 0:
        raise ValueError(f"{what}: empty sequence")


def _check_bwd(q, k, v, do, lse, delta, what):
    _check(q, k, v, ("do", do), what=what)
    if do.shape != q.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError(f"{what}: {name} must be f32 {tuple(q.shape[:3])} "
                             f"on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def kernel_variant(kernel: str, device_type: str, dtype: torch.dtype,
                   head_dim: int):
    """Which implementation of ``kernel`` ("flash_fwd", "flash_bwd_fused",
    "flash_bwd_dq" or "flash_bwd_dkv") takes a call: None (the plain
    version) for a CPU tensor; for a CUDA tensor the entry point ``kernel + "_sm90"`` (TMA,
    wgmma, warp specialisation) at bf16 with head_dim 128, else ``kernel``
    (mma.sync for bf16, FMA for f32). Any other device raises."""
    if device_type == "cpu":
        return None
    if device_type != "cuda":
        raise ValueError(f"{kernel}: unsupported device type {device_type}")
    if dtype == torch.bfloat16 and head_dim == SM90_HEAD_DIM:
        return kernel + "_sm90"
    return kernel


def check_tma_aligned(name, named_tensors) -> None:
    """Raise unless every (label, tensor) starts on a 16-byte boundary,
    which the TMA loads of the Hopper kernels need."""
    for label, x in named_tensors:
        if x.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: {label} starts at {x.data_ptr():#x}, "
                             f"not {TMA_ALIGN}-byte aligned (TMA needs it)")


def _call(name, args, shapes):
    """Launch csrc entry point ``name`` (tensors as pointers, ints as C
    ints, then the current stream); raise on a refused launch, else
    count it."""
    from ray_tpu_torch import _kernels

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: every tensor argument must be contiguous")
    lib = _kernels.load(_LIBRARY[name])
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                   else ctypes.c_int for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = fn(*raw, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({shapes})")
    with _launches_lock:
        _launches[name] += 1


def _dims(q, k, causal, variant):
    """The C entry point's int arguments: the Hopper variants are bf16 at
    head_dim 128 by construction and take neither."""
    b, hq, t, d = q.shape
    sizes = [b, hq, k.shape[1], t, k.shape[2]]
    if not variant.endswith("_sm90"):
        sizes += [d, int(q.dtype == torch.bfloat16)]
    return sizes + [int(bool(causal))]


def _shape_note(q, k):
    return f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}"


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """(out, lse) in the kernel layout [B, H, T, D]. CUDA tensors launch
    the kernel that ``kernel_variant`` names (or raise); CPU tensors take
    the plain version."""
    _check(q, k, v, what="flash_attention_fwd")
    variant = kernel_variant("flash_fwd", q.device.type, q.dtype, q.shape[3])
    if variant is None:
        return flash_attention_fwd_plain(q, k, v, causal=causal)
    if variant == "flash_fwd_sm90":
        check_tma_aligned(variant, (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call(variant, [q, k, v, out, lse, *_dims(q, k, causal, variant)],
          _shape_note(q, k))
    return out, lse


def _bwd_variant(kernel, q, k, v, do, lse, delta):
    """Check a backward call's arguments; return the entry point that
    ``kernel_variant`` names for it (None: the plain version), after the
    alignment check a Hopper kernel's TMA loads need."""
    _check_bwd(q, k, v, do, lse, delta, kernel)
    variant = kernel_variant(kernel, q.device.type, q.dtype, q.shape[3])
    if variant is not None and variant.endswith("_sm90"):
        check_tma_aligned(variant, (("q", q), ("k", k), ("v", v), ("do", do)))
    return variant


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal: bool = True):
    """(dq, dk, dv) by the fused kernel that ``kernel_variant`` names: dq
    is added in f32 into a zeroed buffer (TMA reduce-adds or vector
    atomics), cast to q's dtype here."""
    variant = _bwd_variant("flash_bwd_fused", q, k, v, do, lse, delta)
    if variant is None:
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, causal=causal)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(variant, [q, k, v, do, lse, delta, dq_acc, dk, dv,
                    *_dims(q, k, causal, variant)], _shape_note(q, k))
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """dq by the dq kernel that ``kernel_variant`` names (k loop
    innermost, no atomics: bitwise the same from run to run)."""
    variant = _bwd_variant("flash_bwd_dq", q, k, v, do, lse, delta)
    if variant is None:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal)
    dq = torch.empty_like(q)
    _call(variant, [q, k, v, do, lse, delta, dq,
                    *_dims(q, k, causal, variant)], _shape_note(q, k))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """(dk, dv) by the dkv kernel that ``kernel_variant`` names (q loop
    innermost)."""
    variant = _bwd_variant("flash_bwd_dkv", q, k, v, do, lse, delta)
    if variant is None:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(variant, [q, k, v, do, lse, delta, dk, dv,
                    *_dims(q, k, causal, variant)], _shape_note(q, k))
    return dk, dv


def _use_fused_bwd(t: int, s: int) -> bool:
    """True: one fused kernel; False: the dq and dkv kernels.

    The reference's rule at its default 1024-key blocks, kept for parity
    with the JAX package: fused while the keys span at most 8 tiles (S <=
    8192). On the H100 it is not a speed rule: with both routes on the
    Hopper kernels, the fused kernel times ahead of dq + dkv at every S
    from 2048 to 16384 (chip_smoke.py phase ``bwd_routes``; PERF.md).
    What the two-kernel route does give past 8192 keys is a dq that is
    the same from run to run (no atomics). The reference's T-divisibility
    condition has no counterpart: the kernels mask ragged edges. ``t`` is
    taken to keep the reference's signature."""
    del t
    return cdiv(s, _BLOCK_K) <= _MAX_K_TILES


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True):
    """(dq, dk, dv) from the forward's residuals (kernel layout): delta =
    rowsum(do * out) here, in plain torch, then the gate."""
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    if _use_fused_bwd(q.shape[2], k.shape[2]):
        return flash_bwd_fused(q, k, v, do, lse, delta, causal=causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


# --------------------------------------------------------------------------
# The registered op and its autograd
# --------------------------------------------------------------------------

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal=causal)


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal = causal


def _backward(ctx, d_out, d_lse):
    # lse is a residual, never differentiated (the reference's
    # _flash_apply drops its cotangent)
    del d_lse
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out,
                                     causal=ctx.causal)
    return dq, dk, dv, None


torch.library.register_autograd("ray_tpu_torch::flash_fwd", _backward,
                                setup_context=_setup_context)


def _flash_attention_on_mesh(q, k, v, causal):
    """Flash attention of DTensors: each rank runs the op on its local
    block of batch rows and heads, over the whole sequence (the kernels'
    end-aligned causal mask needs every key of a row), then takes its
    block of q's sequence split again (a local slice). k and v get q's
    split of batch and heads; the GQA map h // (Hq / Hkv) stays local
    when Hkv divides evenly, which is checked."""
    mesh = q.device_mesh
    inner = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                  for p in q.placements)
    heads_split = math.prod(mesh.size(i) for i, p in enumerate(inner)
                            if p == Shard(2))
    if k.shape[2] % heads_split:
        raise ValueError(f"flash_attention: {k.shape[2]} kv heads do not split "
                         f"over the {heads_split} ranks that split the heads")
    run = local_map(functools.partial(flash_attention, causal=causal),
                    out_placements=(inner,), in_placements=(inner,) * 3,
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v).redistribute(mesh, q.placements)


def flash_attention(q, k, v, *, causal: bool = True):
    """Flash attention in the public layout [B, T, H, D] (as ops.attention),
    differentiable. The kernel-layout copies of q, k and v and the
    forward's (out, lse) carry the checkpoint names of the reference's
    ``_layer`` (qkv_q/qkv_k/qkv_v, flash). DTensors run on their local
    shards (``_flash_attention_on_mesh``)."""
    if isinstance(q, DTensor):
        return _flash_attention_on_mesh(q, k, v, causal)
    with checkpoint_name("qkv_q"):
        qt = q.transpose(1, 2).contiguous()
    with checkpoint_name("qkv_k"):
        kt = k.transpose(1, 2).contiguous()
    with checkpoint_name("qkv_v"):
        vt = v.transpose(1, 2).contiguous()
    with checkpoint_name("flash"):
        out, _ = torch.ops.ray_tpu_torch.flash_fwd(qt, kt, vt, bool(causal))
    return out.transpose(1, 2)

