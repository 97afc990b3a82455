"""The part of ``jax.random`` the decode engine samples with, in PyTorch.

The engine's sampling lanes key each token on
``fold_in(PRNGKey(seed), position)`` and draw Gumbel noise from that key,
so a stream's tokens are a function of (seed, position) alone. Porting
the lanes bit for bit means porting threefry2x32 and the way jax turns
its output into floats, as jax 0.9 does it by default
(``jax_threefry_partitionable`` on):

- ``prng_key(seed)``: a 32-bit seed gives the key ``[0, seed]``;
- ``fold_in(key, data)``: ``threefry2x32(key, [0, data])``;
- ``random_bits(key, shape)``: threefry2x32 of the hi and lo 32-bit
  words of a flat iota over ``shape``, the two output words xor-ed;
- ``uniform``: ``bits >> 9 | 0x3f800000`` read as f32, minus 1, scaled,
  then ``max`` with ``minval``;
- ``gumbel``: ``-log(-log(uniform(tiny, 1)))``.

Keys are ``int64`` tensors of shape ``[..., 2]`` holding two 32-bit
words, and every function is batched over the leading key dims. The
32-bit words are computed in ``int64`` and masked after each add and
shift: that is exact on the CPU and on CUDA alike, where torch's
``uint32`` arithmetic is thin and its ``int32`` right shift is
arithmetic. Keys, bits and uniforms equal jax's bit for bit; the Gumbel
noise goes through two ``log`` calls, whose last bit may differ from
XLA's.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1). All int64 tensors of 32-bit values,
    broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & M32
    return x0, x1


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: ``[..., 2]`` = [0, seed]."""
    s = torch.as_tensor(seed, dtype=torch.int64) & M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2], data 32-bit ints broadcast
    against key[..., 0]."""
    k0, k1 = key[..., 0], key[..., 1]
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element: [*key.shape[:-1], *shape] int64 values
    in [0, 2**32), as ``jax.random.bits`` draws them."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    iota = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k1 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    b0, b1 = threefry2x32(k0, k1, iota >> 32, iota & M32)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over [minval, maxval)."""
    bits = random_bits(key, shape)
    one = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = (one - 1.0) * float(hi - lo) + float(lo)
    return torch.clamp(floats, min=float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, its default ("low") mode."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))
