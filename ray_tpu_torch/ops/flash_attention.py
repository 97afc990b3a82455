"""Flash-attention forward: the CUDA kernel (csrc/flash_fwd.cu) and its
plain torch version.

For a CUDA tensor the wrapper launches the kernel or raises; a CPU tensor
takes ``flash_attention_fwd_plain``, which has the same contract:

  q [B, Hq, T, D], k/v [B, Hkv, S, D] -> out [B, Hq, T, D] in q's dtype,
  lse [B, Hq, T] f32 (natural log). Scale d^-1/2, softmax statistics in
  f32, probabilities cast to v's dtype before P.V (f32 accumulation),
  end-aligned causal mask (row i sees keys <= i + S - T), rows that see
  no key give out = 0 and lse = +1e30. GQA: head h reads kv head
  h // (Hq / Hkv).

The kernel has no backward yet: a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 64, 128)
_NEG_INF = -1e30
_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True):
    """Plain torch forward with the kernel's contract (see module doc)."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1)
    sc = torch.matmul(q.float(), kk.transpose(-1, -2)) * (d ** -0.5)
    if causal:
        live = torch.ones((t, s), dtype=torch.bool,
                          device=q.device).tril(diagonal=s - t)
        sc = sc.masked_fill(~live, _NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG_INF * 0.5, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = torch.matmul(p.to(v.dtype).float(), vv.float())
    out = (pv / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, -_NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be 4-D "
                             f"[B, H, T, D], got {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on "
                             f"{x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention_fwd: {name} is {x.dtype}, "
                             f"q is {q.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention_fwd: dtype {q.dtype} not "
                         "supported (bfloat16 or float32)")
    b, hq, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hq % k.shape[1]:
        raise ValueError(f"flash_attention_fwd: Hq={hq} is not a multiple "
                         f"of Hkv={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if t == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention_fwd: empty sequence")


def _launch(q, k, v, causal):
    global _launches
    from ray_tpu_torch import _kernels

    if any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "the CUDA flash-attention kernel has no backward yet (ROADMAP "
            "Queue 1, 'Training slice': the fused backward kernel); run "
            "under torch.no_grad() or pass use_flash=False")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_attention_fwd: q, k and v must be contiguous")
    lib = _kernels.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, hq, hkv, t, s, d,
                int(q.dtype == torch.bfloat16), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    _launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """(out, lse) in the kernel layout [B, H, T, D]. CUDA tensors launch
    the kernel (or raise); CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True):
    """Flash attention in the public layout [B, T, H, D] (as ops.attention)."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out, _ = flash_attention_fwd(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)
