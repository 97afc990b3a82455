"""Tiny policy/value networks for the RL stack, in PyTorch.

Mirrors ray_tpu/rl/models.py: the same parameter tree (``torso``,
``torso2``, ``pi``, ``vf``, each ``{"w": [in, out], "b": [out]}``, the
``x @ W`` orientation) and the same init law (w ~ N(0, 1/in), b = 0),
drawn from a ``torch.Generator`` instead of a JAX key, so the same seed
gives other numbers: ``from_jax_params`` carries a JAX tree across.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def generator(seed_or_gen) -> torch.Generator:
    """A ``torch.Generator`` as given, or a CPU one seeded with the int."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


def dense(gen: torch.Generator, i: int, o: int, device) -> dict:
    """{"w": N(0, 1/i) [i, o], "b": zeros [o]}, drawn in f32 on the
    generator's device."""
    w = torch.randn((i, o), generator=gen, dtype=torch.float32,
                    device=gen.device) / math.sqrt(i)
    return {"w": w.to(device), "b": torch.zeros((o,), dtype=torch.float32,
                                                device=device)}


def init_policy(seed, obs_dim: int, n_actions: int, hidden: int = 64,
                device=None) -> dict:
    """The policy tree, drawn from ``seed`` (an int or a ``torch.Generator``;
    an int draws on the CPU, so the same seed gives the same weights on
    every device)."""
    dev = resolve_device(device)
    gen = generator(seed)
    return {
        "torso": dense(gen, obs_dim, hidden, dev),
        "torso2": dense(gen, hidden, hidden, dev),
        "pi": dense(gen, hidden, n_actions, dev),
        "vf": dense(gen, hidden, 1, dev),
    }


def forward(params, obs):
    """obs [B, obs_dim] -> (logits [B, A], value [B])."""
    h = torch.tanh(obs @ params["torso"]["w"] + params["torso"]["b"])
    h = torch.tanh(h @ params["torso2"]["w"] + params["torso2"]["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[:, 0]
    return logits, value


def from_jax_params(np_tree, device=None) -> dict:
    """A JAX param tree given as numpy (any nesting of dicts, as the
    policy and the RL modules make them) as f32 tensors on ``device``,
    key for key and shape for shape."""
    return as_tensors(np_tree, resolve_device(device))


def to_host(tree):
    """A tree of tensors as CPU tensors (the weights a runner is sent)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def as_tensors(tree, device) -> dict:
    """A host tree (CPU tensors or numpy) as f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: as_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, torch.float32)
    return torch.from_numpy(np.array(tree, np.float32)).to(device)
