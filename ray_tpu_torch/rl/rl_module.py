"""RLModule: the policy-module abstraction, in PyTorch.

Mirrors ray_tpu/rl/rl_module.py (reference rllib/core/rl_module/
rl_module.py:1): a module declares ``forward_train`` /
``forward_inference`` / ``forward_exploration`` and the algorithm's
learner owns the loss, so one network definition serves every
algorithm. A module is a namespace of plain functions over a params
tree (dicts of tensors) that hold only static shape config; state lives
in the tree.

Contract: ``forward_train(params, obs) -> {"logits": [B, A], "vf": [B]}``
for discrete-policy modules. ``forward_inference`` is the greedy action;
``forward_exploration`` samples and returns (action, logp), from a key of
``utils/prng.py`` (threefry, as ``jax.random``; the Gumbel noise's last
bit may differ from XLA's, so samples are not promised bit-equal).

``init(seed, device=None)`` draws from a ``torch.Generator`` (an int
seed draws on the CPU); the trees keep JAX's keys and shapes, so
``models.from_jax_params`` carries a JAX module's tree across.
VisionPolicyModule keeps JAX's NHWC observations and HWIO filters in its
tree and converts to ``F.conv2d``'s NCHW/OIHW inside ``forward_train``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.utils import prng


class RLModule:
    """Abstract module spec. Subclasses hold only STATIC config (shapes,
    hidden sizes); all state lives in the params tree."""

    def init(self, seed, device=None):
        raise NotImplementedError

    def forward_train(self, params, obs) -> dict:
        raise NotImplementedError

    def forward_inference(self, params, obs):
        out = self.forward_train(params, obs)
        return torch.argmax(out["logits"], dim=-1)

    def forward_exploration(self, params, obs, key):
        """``key``: a ``prng.prng_key`` (int64 [2]); categorical sampling
        as ``jax.random.categorical`` draws it (argmax of logits plus
        Gumbel noise)."""
        out = self.forward_train(params, obs)
        logits = out["logits"]
        noise = prng.gumbel(key.to(logits.device), logits.shape)
        act = torch.argmax(logits + noise, dim=-1)
        logp = torch.log_softmax(logits, dim=-1).gather(
            1, act[:, None])[:, 0]
        return act, logp


class DiscretePolicyModule(RLModule):
    """MLP torso + categorical policy + value head: the default module for
    PPO / IMPALA / APPO (wraps the nets in models.py)."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = hidden

    def init(self, seed, device=None):
        return models.init_policy(seed, self.obs_dim, self.n_actions,
                                  hidden=self.hidden, device=device)

    def forward_train(self, params, obs) -> dict:
        logits, vf = models.forward(params, obs)
        return {"logits": logits, "vf": vf}


def _same_pad(size: int, stride: int, kernel: int) -> tuple[int, int]:
    """JAX's "SAME" padding of one spatial dim: the output is
    ceil(size / stride), and an odd total puts the extra row at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class VisionPolicyModule(RLModule):
    """Conv policy for image observations (reference visionnet.py:1): two
    stride-2 3x3 convs -> dense torso -> logits/value heads. obs is
    [B, H, W, C] float (JAX's NHWC); filters are stored HWIO as in JAX."""

    def __init__(self, obs_shape: tuple, n_actions: int,
                 channels: tuple = (16, 32), hidden: int = 128):
        assert len(obs_shape) == 3, "VisionPolicyModule wants [H, W, C]"
        self.obs_shape = tuple(obs_shape)
        self.n_actions = n_actions
        self.channels = tuple(channels)
        self.hidden = hidden

    def _flat_dim(self) -> int:
        h, w, _ = self.obs_shape
        for _c in self.channels:
            h = (h + 1) // 2  # stride-2 SAME conv
            w = (w + 1) // 2
        return h * w * self.channels[-1]

    def init(self, seed, device=None):
        dev = resolve_device(device)
        gen = models.generator(seed)
        params = {}
        cin = self.obs_shape[-1]
        for i, cout in enumerate(self.channels):
            # HWIO filter layout; fan-in scaled init
            w = torch.randn((3, 3, cin, cout), generator=gen,
                            dtype=torch.float32, device=gen.device)
            params[f"conv{i}"] = {
                "w": (w / math.sqrt(9 * cin)).to(dev),
                "b": torch.zeros((cout,), dtype=torch.float32, device=dev),
            }
            cin = cout
        params["torso"] = models.dense(gen, self._flat_dim(), self.hidden, dev)
        params["pi"] = models.dense(gen, self.hidden, self.n_actions, dev)
        params["vf"] = models.dense(gen, self.hidden, 1, dev)
        return params

    def forward_train(self, params, obs) -> dict:
        x = obs.to(torch.float32)
        if x.ndim == 2:  # flattened rows (e.g. riding a [B, D] batch)
            x = x.reshape(-1, *self.obs_shape)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i in range(len(self.channels)):
            p = params[f"conv{i}"]
            top, bottom = _same_pad(x.shape[2], 2, 3)
            left, right = _same_pad(x.shape[3], 2, 3)
            x = F.conv2d(F.pad(x, (left, right, top, bottom)),
                         p["w"].permute(3, 2, 0, 1), stride=2)  # HWIO -> OIHW
            x = F.relu(x + p["b"][:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's NHWC order
        h = torch.tanh(x @ params["torso"]["w"] + params["torso"]["b"])
        logits = h @ params["pi"]["w"] + params["pi"]["b"]
        vf = (h @ params["vf"]["w"] + params["vf"]["b"])[:, 0]
        return {"logits": logits, "vf": vf}
