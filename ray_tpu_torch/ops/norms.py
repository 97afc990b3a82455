"""Normalization ops. RMSNorm is the Llama-family default."""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in f32 accumulation, cast back to input dtype.

    y = x * rsqrt(mean(x^2) + eps) * weight, reduced over the trailing axis.
    """
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
