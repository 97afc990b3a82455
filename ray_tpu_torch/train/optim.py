"""Fused AdamW over f32 master weights, in plain torch.

Mirrors ray_tpu/train/optim.py: the same math as optax.adamw(lr, b1, b2,
eps, weight_decay, mu_dtype) with optional bf16 moments, and the second
moment stored in bf16 by stochastic rounding whose dither bits equal the
JAX package's bit for bit. The JAX update is one XLA-fused pass per leaf
(no Pallas kernel); here each leaf is updated IN PLACE (masters and
moments), which is JAX's ``donate_state`` without the copy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch.utils.trees import tree_leaves

_M32 = 0xFFFFFFFF


def _i32(c: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return c - (1 << 32) if c >= 1 << 31 else c


@dataclasses.dataclass
class FusedAdamWState:
    count: int  # step counter (JAX: int32 scalar)
    mu: dict  # first moment, same tree as the params
    nu: dict  # second moment


def _stochastic_round_bf16(x32: torch.Tensor, key: int) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding, bit-exact with the JAX
    package's ``_stochastic_round_bf16`` (optim.py:31-53).

    A 16-bit dither from a 2-round integer hash of (element index, key)
    is added to the float's bits before the low 16 are dropped, which
    makes the rounding unbiased (a plain cast freezes slow bf16 EMAs).
    JAX computes in uint32. Here the same bits go through int32 tensors:
    add and multiply wrap mod 2**32 in two's complement, which gives the
    uint32 result's bits; a right shift of an int32 copies the sign bit,
    so each logical shift masks the bits it brought in. The final
    arithmetic shift by 16 leaves the kept half as an int16 value.
    Element indices must stay below 2**31."""
    x32 = x32.contiguous()
    bits = x32.view(torch.int32)
    h = torch.arange(x32.numel(), dtype=torch.int32, device=x32.device)
    h = h.view(x32.shape).mul_(_i32(2654435761)).add_(_i32(int(key) & _M32))
    h = h.bitwise_xor_((h >> 15).bitwise_and_(0x1FFFF)).mul_(_i32(0x85EBCA6B))
    h = h.bitwise_xor_((h >> 13).bitwise_and_(0x7FFFF))
    rounded = h.bitwise_and_(0xFFFF).add_(bits)
    return (rounded >> 16).to(torch.int16).view(torch.bfloat16)


class FusedAdamW:
    """``init(params)`` and ``update(grads, state, params)``, as the
    optax.GradientTransformation that JAX's ``fused_adamw`` returns,
    except that ``update`` writes the new params and moments in place
    and returns the new state."""

    def __init__(self, learning_rate, b1, b2, eps, weight_decay, mu_dtype,
                 nu_dtype):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    def init(self, params: dict) -> FusedAdamWState:
        def zeros(tree, dtype_of):
            if isinstance(tree, dict):
                return {k: zeros(v, dtype_of) for k, v in tree.items()}
            return torch.zeros_like(tree, dtype=dtype_of(tree))

        mu = zeros(params, lambda p: self.mu_dtype or p.dtype)
        nu = zeros(params, lambda p: self.nu_dtype or torch.float32)
        return FusedAdamWState(0, mu, nu)

    @torch.no_grad()
    def update(self, grads: dict, state: FusedAdamWState, params: dict):
        """One AdamW step; ``grads`` is a tree like ``params``. Params and
        moments are updated in place; returns the new state (count + 1,
        the same moments)."""
        if params is None:
            raise ValueError("fused_adamw needs params (weight decay)")
        p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        m_leaves, n_leaves = tree_leaves(state.mu), tree_leaves(state.nu)
        if not len(g_leaves) == len(p_leaves) == len(m_leaves) == len(n_leaves):
            raise ValueError("grads, params and moments differ in leaves")
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # optax evaluates schedules at the PRE-increment count (0-based
        # first step); bias correction is 1-based. Match both.
        lr = self.learning_rate(state.count) if callable(self.learning_rate) \
            else self.learning_rate
        lr = float(lr)
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        sr = any(n.dtype == torch.bfloat16 for n in n_leaves)
        # per-leaf seeds from the step counter, by JAX's leaf index
        base = (count * 0x9E3779B9) & _M32
        for i, (g, m, n, p) in enumerate(zip(g_leaves, m_leaves, n_leaves,
                                             p_leaves)):
            g32 = g.float()
            m32 = m.float() * b1 + g32 * (1.0 - b1)
            n32 = n.float() * b2 + g32.square() * (1.0 - b2)
            upd = (m32 / c1) / ((n32 / c2).sqrt() + self.eps) \
                + self.weight_decay * p.float()
            m.copy_(m32)
            if n.dtype == torch.bfloat16 and sr:
                # slow EMAs in bf16 need stochastic rounding or they freeze
                key = (base + (i * 40503) % 2**16) & _M32
                n.copy_(_stochastic_round_bf16(n32, key))
            else:
                n.copy_(n32)
            p.add_((-lr * upd).to(p.dtype))
        return FusedAdamWState(count, state.mu, state.nu)


def fused_adamw(
    learning_rate: float | Callable[[int], float] = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    mu_dtype: torch.dtype | None = None,
    nu_dtype: torch.dtype | None = None,
) -> FusedAdamW:
    """AdamW with optional low-precision moments, as JAX's ``fused_adamw``.

    ``learning_rate`` is a float or a schedule called with the step count
    before its increment (optax's convention). ``nu_dtype=bfloat16``
    stores the second moment by stochastic rounding (bit-exact with the
    JAX package); ``mu_dtype=bfloat16`` rounds the first moment to
    nearest."""
    return FusedAdamW(learning_rate, b1, b2, eps, weight_decay, mu_dtype,
                      nu_dtype)

