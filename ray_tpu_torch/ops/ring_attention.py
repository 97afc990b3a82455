"""Ring attention: sequence-parallel attention over the sp mesh axis.

Mirrors ray_tpu/ops/ring_attention.py. Each rank holds T/n rows of q, k
and v (its sequence block). In n ring steps the k/v blocks travel one
neighbour on per step (``mesh_ppermute``) while each rank's q block
accumulates attention by the online-softmax update (the flash kernels'
m / l / acc recurrence). Gradients come from autograd through the ring
(the permute's backward is the reverse shift), as JAX's come from
transposing the scan, so there is no hand-written backward. JAX's block
product is an einsum, not a Pallas kernel; so is this one.

Layout: q [B, T/n, Hq, D], k/v [B, T/n, Hkv, D] on each rank.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.collective.mesh_ops import mesh_ppermute
from ray_tpu_torch.ops.attention import _repeat_kv

_NEG_INF = -1e30


def _block_attn(q, k, v, q_start: int, k_start: int, causal: bool, scale: float):
    """One block in f32; returns (pv, m, l) unnormalized. q: [B, Tq, H, D];
    k/v: [B, Tk, H, D] (kv heads already matched). m/l: [B, H, Tq] row max
    / row sum of exp(s - m); rows with every key masked contribute 0."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        rows = q_start + torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = k_start + torch.arange(s.shape[-1], device=s.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where((m > _NEG_INF * 0.5)[..., None], torch.exp(s - m[..., None]),
                    0.0)
    pv = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    return pv, m, p.sum(dim=-1)


def _rows(x):
    """[B, H, T] -> [B, T, H, 1] to broadcast over head_dim."""
    return x.transpose(1, 2)[..., None]


def ring_attention(q, k, v, mesh: DeviceMesh, *, axis: str = "sp",
                   causal: bool = True, remat_blocks: bool = True):
    """This rank's rows of attention_reference(q, k, v) over the whole
    sequence, from its rows of q, k and v (block ``i`` of the sequence on
    the member at coordinate i of ``axis``). ``remat_blocks`` recomputes
    each block's [T/n, T/n] logits in the backward
    (``torch.utils.checkpoint``) instead of keeping them."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    n_rep = q.shape[2] // k.shape[2]
    scale = q.shape[-1] ** -0.5
    b, tl, h, d = q.shape
    q_start = idx * tl
    block = functools.partial(_block_attn, causal=causal, scale=scale)
    acc = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, h, tl), _NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for step in range(n):
        # the k/v held now started on member (idx - step) mod n
        k_start = ((idx - step) % n) * tl
        args = (q, _repeat_kv(kb, n_rep), _repeat_kv(vb, n_rep), q_start, k_start)
        if remat_blocks:
            pv, m_blk, l_blk = checkpoint(block, *args, use_reentrant=False)
        else:
            pv, m_blk, l_blk = block(*args)
        m_new = torch.maximum(m_run, m_blk)
        # guard fully-masked m values (exp(-inf - -inf))
        corr_run = torch.where(m_run > _NEG_INF * 0.5, torch.exp(m_run - m_new), 0.0)
        corr_blk = torch.where(m_blk > _NEG_INF * 0.5, torch.exp(m_blk - m_new), 0.0)
        acc = acc * _rows(corr_run) + pv * _rows(corr_blk)
        l_run = l_run * corr_run + l_blk * corr_blk
        m_run = m_new
        if step < n - 1:
            kb = mesh_ppermute(kb, mesh, axis)
            vb = mesh_ppermute(vb, mesh, axis)
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    return (acc / _rows(l_safe)).to(q.dtype)
