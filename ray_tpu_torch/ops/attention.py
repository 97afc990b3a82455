"""Attention ops: torch reference + dispatch to the CUDA flash kernel.

Layout convention throughout: q [B, T, Hq, D], k/v [B, S, Hkv, D] with
Hq % Hkv == 0 (grouped-query attention; Hkv == Hq is vanilla MHA).
"""

from __future__ import annotations

import torch


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] by repeating each kv head."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attention_reference(q, k, v, *, causal: bool = True):
    """O(T*S)-memory reference attention.

    Logits and softmax in f32 regardless of input dtype; the probabilities
    are cast to v's dtype before P.V (f32 accumulation); returns q.dtype.
    The causal mask is end-aligned (tril(k=S-T)); rows that see no key
    (T > S under causal) output 0.
    """
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    empty_rows = None
    if causal:
        t, s = logits.shape[-2:]
        mask = torch.ones((t, s), dtype=torch.bool,
                          device=q.device).tril(diagonal=s - t)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        if s < t:
            empty_rows = ~mask.any(-1)  # [t]
    probs = torch.softmax(logits, dim=-1)
    if empty_rows is not None:
        probs = probs.masked_fill(empty_rows[None, None, :, None], 0.0)
    out = torch.einsum("bhts,bshd->bthd",
                       probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = True, use_flash: bool | None = None):
    """Dispatching attention entry point.

    use_flash=None or True -> ``flash_attention``: the CUDA kernel for
    CUDA tensors (or an error), its plain torch version for CPU tensors.
    use_flash=False -> ``attention_reference``.
    """
    if use_flash is False:
        return attention_reference(q, k, v, causal=causal)
    from ray_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=causal)
