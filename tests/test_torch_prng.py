"""The port's threefry PRNG (ray_tpu_torch/utils/prng.py) against jax.random.

Keys, fold_in, raw bits and uniforms must equal jax's bit for bit, over
seeds {0, 1, 2**31+7, 2**32-1}, positions {0, 1, 4095} and shapes {(256,),
(257,), (32128,), (3, 5)}, batched over keys as the engine uses them. The
Gumbel noise goes through two logs, whose last bit may differ between
torch and XLA: it agrees within 2 ulp, the ulp taken at max(|g|, 1) (near
g = 0 the outer log's relative error is a tiny absolute one, far below
the resolution of the logits the noise is added to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.utils import prng

SEEDS = np.array([0, 1, 2**31 + 7, 2**32 - 1], np.uint32)
POSITIONS = np.array([0, 1, 4095], np.int32)
SHAPES = [(256,), (257,), (32128,), (3, 5)]
GUMBEL_ULPS = 2.0


def _jax_keys():
    """[seed, pos] -> jax key of fold_in(PRNGKey(seed), pos)."""
    return {(int(s), int(p)): jax.random.fold_in(jax.random.PRNGKey(s), p)
            for s in SEEDS for p in POSITIONS}


def _port_keys():
    """The same keys, batched: [len(SEEDS) * len(POSITIONS), 2] int64."""
    seeds = torch.from_numpy(np.repeat(SEEDS, len(POSITIONS)).astype(np.int64))
    pos = torch.from_numpy(np.tile(POSITIONS, len(SEEDS)))
    return prng.fold_in(prng.prng_key(seeds), pos)


def _stack(jkeys, fn):
    return np.stack([np.asarray(fn(jkeys[(int(s), int(p))]))
                     for s in SEEDS for p in POSITIONS])


def test_prng_key_and_fold_in_bit_exact():
    for s in SEEDS:
        want = np.asarray(jax.random.PRNGKey(s)).astype(np.int64)
        assert prng.prng_key(torch.tensor(int(s))).tolist() == want.tolist()
    want = _stack(_jax_keys(), lambda k: k).astype(np.int64)
    assert np.array_equal(_port_keys().numpy(), want)
    # fold_in of a folded key (a key that is not [0, seed])
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 3), 2**31)
    got = prng.fold_in(prng.fold_in(prng.prng_key(5), 3), 2**31)
    assert got.tolist() == np.asarray(k).astype(np.int64).tolist()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_bit_exact(shape):
    jkeys, keys = _jax_keys(), _port_keys()
    want_bits = _stack(jkeys, lambda k: jax.random.bits(k, shape, jnp.uint32))
    assert np.array_equal(prng.random_bits(keys, shape).numpy(),
                          want_bits.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        want = _stack(jkeys, lambda k: jax.random.uniform(
            k, shape, minval=lo, maxval=hi))
        got = prng.uniform(keys, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_two_ulp(shape):
    want = _stack(_jax_keys(), lambda k: jax.random.gumbel(k, shape))
    got = prng.gumbel(_port_keys(), shape).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    gap = np.abs(got.astype(np.float64) - want) / ulp
    assert gap.max() <= GUMBEL_ULPS, gap.max()
