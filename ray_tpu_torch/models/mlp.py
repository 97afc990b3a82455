"""Minimal MLP classifier and the speculative draft's residual adapter
head, in PyTorch.

Mirrors ray_tpu/models/mlp.py. The classifier (``MLPConfig``,
``init_params``, ``forward``, ``loss_fn``) is the MNIST-class smoke-test
workload: ReLU hidden layers, f32 logits, mean cross-entropy and
accuracy. The draft head is a 2-layer bottleneck MLP applied residually
to the draft trunk's hidden state, ``h -> h + relu(h @ w1 + b1) @ w2``,
in f32. Its down projection ``w2`` starts at zero, so a fresh head is the
identity and the draft proposes exactly the truncated trunk's tokens; a
distillation pass may later move ``w2`` away from zero to raise the
acceptance rate.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.losses import softmax_cross_entropy

_KEYS = ("w1", "b1", "w2")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_in: int = 784
    d_hidden: int = 512
    n_hidden: int = 2
    d_out: int = 10
    dtype: str = "float32"


def init_params(cfg: MLPConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """f32 params with JAX's init law: layer i's w ~ N(0, 1/d_in of the
    layer), b = 0. Drawn from ``generator`` (seed 0 on the target device
    when None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_hidden + [cfg.d_out]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims, dims[1:])):
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32, device=generator.device)
        params[f"layer{i}"] = {
            "w": (w / math.sqrt(d_in)).to(dev),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=dev)}
    return params


def param_logical_axes(cfg: MLPConfig) -> dict:
    return {f"layer{i}": {"w": ("embed", "mlp"), "b": ("norm",)}
            for i in range(cfg.n_hidden + 1)}


def forward(params, x, cfg: MLPConfig):
    """x [B, d_in] -> f32 logits [B, d_out], computed in ``cfg.dtype``."""
    n = cfg.n_hidden + 1
    h = x.to(params["layer0"]["w"].device, _DTYPES[cfg.dtype])
    for i in range(n):
        p = params[f"layer{i}"]
        h = h @ p["w"].to(h.dtype) + p["b"].to(h.dtype)
        if i < n - 1:
            h = torch.relu(h)
    return h.float()


def loss_fn(params, batch, cfg: MLPConfig):
    """batch {'x': [B, d_in], 'y': [B] int} -> (mean cross-entropy,
    {'loss', 'accuracy'})."""
    logits = forward(params, batch["x"], cfg)
    labels = batch["y"].to(logits.device)
    loss, _ = softmax_cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


# --------------------------------------------------------------------------
# Residual adapter: the speculative-decode draft head
# --------------------------------------------------------------------------


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
