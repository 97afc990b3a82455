"""Wire codecs for the ring collective, in PyTorch.

The port's counterpart of ray_tpu/collective/compression.py, frame for
frame: the same codecs, the same frame keys and the same bytes.

- ``none``: dtype passthrough (raw bytes, exact);
- ``bf16``: float payloads rounded to bfloat16 (2 bytes an element);
- ``int8``: EQuARX-style block-scaled int8 (arXiv:2506.17615), one f32
  max-abs scale per ``QUANT_BLOCK`` elements, round half to even; ~26%
  of the f32 wire bytes at the default block of 512.

Lossy codecs compose with error feedback (:func:`encode_with_ef`): the
quantization residual of one call is added back into the tensor at the
next, so compression error is carried forward rather than lost.

A payload is a numpy array or a CPU tensor. JAX takes bfloat16 from
``ml_dtypes``; the port rounds through ``torch.bfloat16`` instead (round
to nearest even, as ``ml_dtypes``) and carries a bf16 payload's bytes as
an ``int16`` view, so a bf16 tensor is a float payload as JAX's bf16
arrays are. :func:`decode` returns a CPU tensor. The int8 block math is
JAX's numpy code on the f32 payload, so scales and mantissas are its
bits (numpy is also ~5× faster than torch on these 1 MiB chunks).

The module constants stand for the JAX runtime's config flags at their
defaults (ray_tpu/_private/config.py:158-177).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

# JAX's config defaults (collective_transport, _codec, _chunk_bytes,
# _timeout_s, _quant_block, _bucket_bytes, _abort_poll_s)
TRANSPORT = "ring"
CODEC = "none"
CHUNK_BYTES = 1024 * 1024
TIMEOUT_S = 120.0
QUANT_BLOCK = 512
BUCKET_BYTES = 4 * 1024 * 1024
ABORT_POLL_S = 0.5


def as_tensor(arr) -> torch.Tensor:
    """A contiguous CPU tensor of ``arr`` (a numpy array is viewed, not
    copied, where it is contiguous)."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise TypeError(f"collective payloads live on the host, not on "
                            f"{arr.device}")
        return arr.detach().contiguous()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point()


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ("float32", "bfloat16", ...), as
    JAX's frames carry it."""
    return str(dtype).removeprefix("torch.")


def _wire_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _tobytes(t: torch.Tensor) -> bytes:
    if not t.numel():
        return b""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _frombytes(data, dtype: torch.dtype) -> torch.Tensor:
    """A read-only view of ``data`` as a flat tensor of ``dtype``."""
    if not len(data):
        return torch.empty(0, dtype=dtype)
    with warnings.catch_warnings():  # a view of immutable bytes is read only
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8).view(dtype)


def _frame_meta(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}


def _restore(flat: torch.Tensor, frame: dict) -> torch.Tensor:
    return flat.reshape(frame["shape"])


class Codec:
    """One wire codec: payload -> framed dict -> tensor. ``lossless``
    lets the error-feedback wrapper skip the decode round trip when there
    is no residual to extract."""

    name = "base"
    lossless = True

    def encode(self, arr) -> dict:
        raise NotImplementedError

    def decode(self, frame: dict) -> torch.Tensor:
        raise NotImplementedError


class PassthroughCodec(Codec):
    name = "none"
    lossless = True

    def encode(self, arr) -> dict:
        t = as_tensor(arr)
        f = _frame_meta(t)
        f.update(codec=self.name, data=_tobytes(t))
        return f

    def decode(self, frame: dict) -> torch.Tensor:
        return _restore(_frombytes(frame["data"], _wire_dtype(frame["dtype"])),
                        frame)


def _raw(codec: Codec, t: torch.Tensor) -> dict:
    """A non-float payload, passed through under ``codec``'s name."""
    f = PassthroughCodec().encode(t)
    f["codec"] = codec.name
    f["enc"] = "raw"
    return f


class Bf16Codec(Codec):
    """Round float payloads to bfloat16; non-floats pass through."""

    name = "bf16"
    lossless = False

    def encode(self, arr) -> dict:
        t = as_tensor(arr)
        if not _is_float(t):
            return _raw(self, t)
        f = _frame_meta(t)
        f.update(codec=self.name, enc="bf16",
                 data=_tobytes(t.to(torch.bfloat16)))
        return f

    def decode(self, frame: dict) -> torch.Tensor:
        if frame.get("enc") == "raw":
            return PassthroughCodec().decode(frame)
        flat = _frombytes(frame["data"], torch.bfloat16)
        return _restore(flat.to(_wire_dtype(frame["dtype"])), frame)


class BlockInt8Codec(Codec):
    """Block-scaled int8 (EQuARX §3): a max-abs f32 scale a block and
    round-half-even int8 mantissas. Non-float payloads pass through
    (quantizing an exact integer reduction would corrupt it)."""

    name = "int8"
    lossless = False

    def __init__(self, block: int | None = None):
        self.block = int(block or QUANT_BLOCK)

    def encode(self, arr) -> dict:
        t = as_tensor(arr)
        if not _is_float(t):
            return _raw(self, t)
        flat = t.to(torch.float32).reshape(-1).numpy()
        n = flat.size
        nblocks = max(1, -(-n // self.block))
        if n == nblocks * self.block:  # whole blocks: no padded copy
            padded = flat
        else:
            padded = np.zeros(nblocks * self.block, dtype=np.float32)
            padded[:n] = flat
        blocks = padded.reshape(nblocks, self.block)
        scales = np.abs(blocks).max(axis=1) / 127.0
        safe = np.where(scales == 0.0, 1.0, scales).astype(np.float32)
        q = np.rint(blocks / safe[:, None]).astype(np.int8)
        f = _frame_meta(t)
        f.update(codec=self.name, enc="int8", block=self.block,
                 data=q.tobytes()[:n],
                 scales=scales.astype(np.float32).tobytes())
        return f

    def decode(self, frame: dict) -> torch.Tensor:
        if frame.get("enc") == "raw":
            return PassthroughCodec().decode(frame)
        block = frame["block"]
        q = np.frombuffer(frame["data"], dtype=np.int8)
        scales = np.frombuffer(frame["scales"], dtype=np.float32)
        n = q.size
        nblocks = scales.size
        if n == nblocks * block:
            padded = q
        else:
            padded = np.zeros(nblocks * block, dtype=np.int8)
            padded[:n] = q
        out = torch.from_numpy((padded.reshape(nblocks, block).astype(np.float32)
                                * scales[:, None]).ravel()[:n])
        out_dtype = _wire_dtype(frame["dtype"])
        if out_dtype.is_floating_point:
            out = out.to(out_dtype)
        return _restore(out, frame)


_CODECS = {
    "none": PassthroughCodec,
    "bf16": Bf16Codec,
    "int8": BlockInt8Codec,
}


def get_codec(codec: "str | Codec | None") -> Codec:
    """Resolve a codec name (or pass an instance through); None is
    ``CODEC``."""
    if isinstance(codec, Codec):
        return codec
    name = codec or CODEC
    try:
        return _CODECS[name]()
    except KeyError:
        raise ValueError(
            f"unknown collective codec {name!r}; have {sorted(_CODECS)}"
        ) from None


def wire_bytes(frame: dict) -> int:
    """Payload bytes a frame puts on the wire (data + scales; the few
    bytes of shape and dtype are left out, so accounting stays exact)."""
    return len(frame.get("data", b"")) + len(frame.get("scales", b""))


def encode_with_ef(codec: Codec, arr, residual):
    """Error-feedback encode: fold the previous residual (an f32 tensor or
    None) into the payload, encode, and return ``(frame, new_residual)``.
    For a lossless codec or a non-float payload the residual is None. A
    residual of the payload's shape is folded in and then overwritten
    with the new one, which is returned (the ring keeps one a chunk)."""
    t = as_tensor(arr)
    if codec.lossless or not _is_float(t):
        return codec.encode(t), None
    work = t.to(torch.float32)
    reuse = residual is not None and tuple(residual.shape) == tuple(work.shape)
    if reuse:
        work = work + residual
    frame = codec.encode(work.to(t.dtype) if t.dtype != torch.float32
                         else work)
    decoded = codec.decode(frame).to(torch.float32)
    return frame, torch.sub(work, decoded, out=residual if reuse else None)
