"""Fused AdamW over f32 master weights, in plain torch.

Mirrors ray_tpu/train/optim.py: the same math as optax.adamw(lr, b1, b2,
eps, weight_decay, mu_dtype) with optional bf16 moments, and the second
moment stored in bf16 by stochastic rounding whose dither bits equal the
JAX package's bit for bit. The JAX update is one XLA-fused pass per leaf
(no Pallas kernel); here each leaf is updated IN PLACE (masters and
moments), which is JAX's ``donate_state`` without the copy. DTensor
leaves (a train state on a mesh) are updated on each rank's local
blocks, the rounding of each element seeded by its index in the whole
leaf, so a sharded update gives the one-device update's bits.

``adam`` is optax.adam (the JAX RL learners' optimizer) in optax's order
of operations, functional like optax, for the port's RL layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel.sharding import local_slices
from ray_tpu_torch.utils.trees import tree_leaves, tree_map

_M32 = 0xFFFFFFFF


def _i32(c: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return c - (1 << 32) if c >= 1 << 31 else c


@dataclasses.dataclass
class FusedAdamWState:
    count: int  # step counter (JAX: int32 scalar)
    mu: dict  # first moment, same tree as the params
    nu: dict  # second moment


def _flat_index(shape, block, device) -> torch.Tensor:
    """int32 [block's shape]: each element's flat index in a contiguous
    tensor of ``shape``, for the block ``block`` (a slice a dim) of it."""
    idx = torch.zeros([s.stop - s.start for s in block], dtype=torch.int32,
                      device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[d] = -1
        idx += (torch.arange(block[d].start, block[d].stop, dtype=torch.int32,
                             device=device) * stride).view(view)
        stride *= shape[d]
    return idx


def _stochastic_round_bf16(x32: torch.Tensor, key: int,
                           index: torch.Tensor | None = None) -> torch.Tensor:
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
    ``index`` holds each element's index in the whole leaf, for a block
    of it (JAX's iota runs over the global array, so a shard rounds as
    the whole leaf does); None: x32 is the whole leaf. Element indices
    must stay below 2**31."""
    x32 = x32.contiguous()
    bits = x32.view(torch.int32)
    if index is None:
        h = torch.arange(x32.numel(), dtype=torch.int32, device=x32.device)
        h = h.view(x32.shape)
    else:
        h = index.clone()
    h = h.mul_(_i32(2654435761)).add_(_i32(int(key) & _M32))
    h = h.bitwise_xor_((h >> 15).bitwise_and_(0x1FFFF)).mul_(_i32(0x85EBCA6B))
    h = h.bitwise_xor_((h >> 13).bitwise_and_(0x7FFFF))
    rounded = h.bitwise_and_(0xFFFF).add_(bits)
    return (rounded >> 16).to(torch.int16).view(torch.bfloat16)


def _local_blocks(leaves):
    """(grad, mu, nu, param) of one leaf as tensors to update in place: the
    leaves themselves, or, for DTensors, their local blocks, which must
    lie alike (the step brings each gradient to its param's sharding)."""
    if not isinstance(leaves[3], DTensor):
        return leaves
    p = leaves[3]
    for x in leaves:
        if not isinstance(x, DTensor) or x.device_mesh != p.device_mesh \
                or tuple(x.placements) != tuple(p.placements):
            raise ValueError("fused_adamw: a leaf's gradient, moments and "
                             "param must be DTensors placed alike; got "
                             f"{[getattr(y, 'placements', None) for y in leaves]}")
    return tuple(x.to_local() for x in leaves)


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
        for i, leaves in enumerate(zip(g_leaves, m_leaves, n_leaves, p_leaves)):
            g, m, n, p = _local_blocks(leaves)
            g32 = g.float()
            m32 = m.float() * b1 + g32 * (1.0 - b1)
            n32 = n.float() * b2 + g32.square() * (1.0 - b2)
            upd = (m32 / c1) / ((n32 / c2).sqrt() + self.eps) \
                + self.weight_decay * p.float()
            m.copy_(m32)
            if n.dtype == torch.bfloat16 and sr:
                # slow EMAs in bf16 need stochastic rounding or they freeze
                key = (base + (i * 40503) % 2**16) & _M32
                index = None
                if isinstance(leaves[3], DTensor):
                    pd = leaves[3]
                    index = _flat_index(pd.shape, local_slices(
                        pd.shape, pd.device_mesh, pd.placements), n.device)
                n.copy_(_stochastic_round_bf16(n32, key, index))
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



@dataclasses.dataclass
class AdamState:
    count: int  # steps taken (optax: int32 scalar)
    mu: dict  # first moment, same tree as the params
    nu: dict  # second moment


class Adam:
    """``optax.adam`` (``scale_by_adam`` then the scale by -lr) as plain
    torch ops on trees of tensors, in optax's order of operations:
    ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g**2 + b2*nu``, each divided
    by its bias correction ``1 - b**count`` (in f32, as JAX computes it),
    ``u = mu_hat / (sqrt(nu_hat + eps_root) + eps) * -lr``. Functional,
    as optax is: ``update`` returns new updates and a new state, and
    :func:`apply_updates` adds the updates to the params."""

    def __init__(self, learning_rate: float, b1: float, b2: float,
                 eps: float, eps_root: float):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params: dict) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params=None):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, n: (1 - b2) * g ** 2 + b2 * n, grads,
                      state.nu)
        count = state.count + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        lr = -float(self.learning_rate)
        updates = tree_map(
            lambda m, n: (m / c1) / (torch.sqrt(n / c2 + self.eps_root)
                                     + self.eps) * lr, mu, nu)
        return updates, AdamState(count, mu, nu)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Adam:
    """``optax.adam`` with its defaults, for the RL learners."""
    return Adam(learning_rate, b1, b2, eps, eps_root)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``optax.apply_updates``: ``p + u`` in the param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
