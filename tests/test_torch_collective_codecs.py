"""The port's wire codecs (``ray_tpu_torch/collective/compression.py``)
frame for frame against the JAX package's.

Seeded f32, bf16 and int32 payloads, with a ragged last int8 block, go
through each codec of both: the frames (data and scale bytes, shape,
dtype, codec, encoding, block) and ``wire_bytes`` are equal, and so are
the decoded bits. ``encode_with_ef`` over 3 successive calls gives the
same frames and residuals bit for bit. An unknown codec name raises
``ValueError`` in both. JAX's bf16 payloads are ``ml_dtypes`` arrays; the
port's are ``torch.bfloat16`` tensors of the same bits.
"""

import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.collective import compression as jcomp
from ray_tpu_torch.collective import compression

BF16 = np.dtype(ml_dtypes.bfloat16)
SHAPES = [(1000,), (33, 31), (512,), (0,)]  # 1000 and 1023 end ragged at 512


def payloads(dtype: str, shape, seed: int):
    """(JAX's array, the port's tensor) of the same seeded bits."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, shape).astype(np.int32)
        return x, torch.from_numpy(x.copy())
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 100.0)).astype(np.float32)
    if x.size:
        x.reshape(-1)[::97] = 0.0  # zero elements, and an all-zero block below
    if x.size >= 1024:
        x.reshape(-1)[512:1024] = 0.0
    if dtype == "float32":
        return x, torch.from_numpy(x.copy())
    jx = x.astype(BF16)
    return jx, torch.from_numpy(jx.view(np.int16).copy()).view(torch.bfloat16)


def bits(x):
    """(dtype name, shape, bytes) of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        data = (x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                if x.numel() else b"")
        return str(x.dtype).removeprefix("torch."), tuple(x.shape), data
    x = np.asarray(x)
    return x.dtype.name, tuple(x.shape), np.ascontiguousarray(x).tobytes()


def assert_same_frame(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert got[k] == want[k], k


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_frames_and_decodes_equal_jax(codec, dtype, shape):
    jx, tx = payloads(dtype, shape, seed=zlib.crc32(f"{codec}{dtype}{shape}".encode()))
    want = jcomp.get_codec(codec).encode(jx)
    got = compression.get_codec(codec).encode(tx)
    assert_same_frame(got, want)
    assert compression.wire_bytes(got) == jcomp.wire_bytes(want)
    assert bits(compression.get_codec(codec).decode(got)) == \
        bits(jcomp.get_codec(codec).decode(want))


def test_int8_frame_size_for_a_bf16_payload():
    """n int8 bytes and 4 a block of 512: the figure the card checks."""
    n = 3 * 512 + 7
    jx, tx = payloads("bfloat16", (n,), seed=5)
    frame = compression.BlockInt8Codec().encode(tx.float())
    assert compression.wire_bytes(frame) == n + 4 * -(-n // 512)
    assert compression.wire_bytes(frame) == jcomp.wire_bytes(
        jcomp.BlockInt8Codec().encode(jx.astype(np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_error_feedback_equals_jax_over_three_calls(codec, dtype):
    jres = tres = None
    for call in range(3):
        jx, tx = payloads(dtype, (1000,), seed=40 + call)
        jframe, jres = jcomp.encode_with_ef(jcomp.get_codec(codec), jx, jres)
        tframe, tres = compression.encode_with_ef(
            compression.get_codec(codec), tx, tres)
        assert_same_frame(tframe, jframe)
        if jres is None:
            assert tres is None
        else:
            assert bits(tres) == bits(jres)


def test_unknown_codec_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown collective codec") as want:
        jcomp.get_codec("fp4")
    with pytest.raises(ValueError, match="unknown collective codec") as got:
        compression.get_codec("fp4")
    assert str(got.value) == str(want.value)
    codec = compression.BlockInt8Codec(block=64)
    assert compression.get_codec(codec) is codec
    assert compression.get_codec(None).name == "none"
