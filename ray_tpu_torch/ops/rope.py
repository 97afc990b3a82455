"""Rotary position embeddings (RoPE), Llama convention (half-split)."""

import torch


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0):
    """Return f32 (sin, cos) tables of shape positions.shape + (head_dim // 2,)."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=positions.device) / half))
    angles = positions.to(torch.float32)[..., None] * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """Rotate pairs (x1, x2) = (x[..., :half], x[..., half:]).

    x: [..., T, n_heads, head_dim]; sin/cos: [..., T, half] in f32
    (broadcast over heads). Computed in f32, cast back to x.dtype.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
