"""The speculative draft's residual adapter head, in PyTorch.

Mirrors the draft-head half of ray_tpu/models/mlp.py: a 2-layer
bottleneck MLP applied residually to the draft trunk's hidden state,
``h -> h + relu(h @ w1 + b1) @ w2``, in f32. The down projection ``w2``
starts at zero, so a fresh head is the identity and the draft proposes
exactly the truncated trunk's tokens; a distillation pass may later move
``w2`` away from zero to raise the acceptance rate. (The MNIST MLP
classifier of the same JAX module is not on the serving path.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

_KEYS = ("w1", "b1", "w2")


def init_draft_head(d_model: int, generator: torch.Generator | None = None,
                    d_hidden: int = 0, device=None) -> dict:
    """w1 ~ N(0, 1/d_model), b1 = 0, w2 = 0 (the identity), all f32."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d_hidden = d_hidden or max(8, d_model // 4)
    w1 = torch.randn((d_model, d_hidden), generator=generator,
                     dtype=torch.float32, device=generator.device)
    return {"w1": (w1 / math.sqrt(d_model)).to(dev),
            "b1": torch.zeros((d_hidden,), dtype=torch.float32, device=dev),
            "w2": torch.zeros((d_hidden, d_model), dtype=torch.float32,
                              device=dev)}


def draft_head_from_jax(np_tree: dict, device=None) -> dict:
    """A JAX draft head given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, head)``), as f32 tensors."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(np_tree[k], np.float32)).to(dev)
            for k in _KEYS}


def apply_draft_head(head, h):
    """h: [..., d_model] (any leading shape). Identity when w2 == 0, and
    when ``head`` is None."""
    if head is None:
        return h
    hd = h.float()
    up = torch.relu(hd @ head["w1"] + head["b1"])
    return (hd + up @ head["w2"]).to(h.dtype)
