"""Checkpoints of a train state, sharded or not, with crc32 integrity.

The port's own copy of ray_tpu/train/checkpoint.py, in the same on-disk
format, so a checkpoint written by either package reads in the other.
``ship_checkpoint``/``fetch_checkpoint`` ride the object store of a
runtime value (``serve.runtime``'s ``put(owned=True)`` and ``get``; None:
in-process). One directory per checkpoint:

    meta.msgpack         {"leaves": [{"kind": "array", "shape", "dtype",
                         "spec"} or {"kind": "py"}, ...], "n_leaves",
                         "n_writers"}
    shards_p{k}.npz      process k's shards, one member per distinct
                         shard: "{leaf}/{start}:{stop},..." (stop -1 for
                         a dim that is not split)
    treedef.pkl          (tree structure, the non-array leaves)
    user.pkl             the ``extra`` payload, or a dict checkpoint
    checksums_*.json     each writer's crc32 of every member it wrote

Leaf i is the same leaf in both packages: the state is flattened in
JAX's ``tree_flatten`` order (dict keys sorted; a dataclass by its
fields, so ``TrainState`` is step, params, opt_state and the optimizer
state count, mu, nu). The port's ``TrainState.step`` and
``FusedAdamWState.count`` are Python ints, which JAX holds as int32
scalars: an int field of a dataclass is saved as a 0-d int32 array leaf
and restored as an int. A bf16 leaf is saved as its 2-byte payload,
which is what JAX's file holds (numpy writes ml_dtypes' bfloat16 as
``<V2``), with dtype "bfloat16" in meta; it is viewed back as
``torch.bfloat16`` on restore. (The JAX package hands that ``<V2``
array to ``jax.device_put``, which refuses it: JAX cannot restore its
own bf16 leaves. The port can.) ``meta.msgpack`` is written by a small
encoder of the msgpack subset meta uses, byte for byte what
``msgpack.packb`` gives.

The one deviation from JAX's format: JAX's ``treedef.pkl`` pickles a JAX
``PyTreeDef``, which cannot be unpickled without jax. The port writes
its own picklable structure record under the same name (with an
``unflatten(leaves)`` method, which is all JAX's restore asks of a
treedef, so JAX restores a checkpoint the port wrote). To restore a
checkpoint that JAX wrote, the port takes the structure from the
``shardings`` tree or from ``like=``; it still verifies the member's
crc32, and reads JAX's non-array leaves from it with JAX's classes
stubbed out.

Integrity: restores verify the recorded crc32s before deserializing, so a
torn or altered checkpoint raises :class:`CheckpointCorruptError` (the
trainer falls back to the previous checkpoint) instead of a pickle or zip
traceback. The fault sites ``checkpoint.save`` (``drop`` = a torn write:
half the bytes land, the checksum records all of them) and
``checkpoint.restore`` (``drop`` = detected bitrot) make both paths
testable (``train/fault_injection.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import shutil
import struct
import tempfile
import time
import zipfile
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.mesh import active_mesh
from ray_tpu_torch.parallel.sharding import (NamedSharding, local_slices,
                                             spec_to_placements)
from ray_tpu_torch.train import fault_injection
from ray_tpu_torch.train import session as _sess

logger = logging.getLogger(__name__)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (missing file, crc32
    mismatch, an unreadable record, or an injected bitrot)."""

    def __init__(self, path: str, detail: str):
        self.path = path
        self.detail = detail
        super().__init__(f"corrupt checkpoint at {path}: {detail}")


# ---- msgpack, the subset meta.msgpack uses ----


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dict, list, tuple, str, int, bool,
    None), as ``msgpack.packb(obj)`` gives them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                     (0xFFFFFFFF, 0xCE, ">I"),
                                     (2**64 - 1, 0xCF, ">Q")):
                if obj <= limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(obj)
        else:
            for limit, code, fmt in ((-2**7, 0xD0, ">b"), (-2**15, 0xD1, ">h"),
                                     (-2**31, 0xD2, ">i"), (-2**63, 0xD3, ">q")):
                if obj >= limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_len(n: int, fix: int, code16: int, out: bytearray) -> None:
    if n <= 15:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(code16)
        out += struct.pack(">H", n)
    else:
        out.append(code16 + 1)
        out += struct.pack(">I", n)


def unpackb(data: bytes):
    """The object of msgpack bytes in the subset :func:`packb` writes
    (arrays come back as lists)."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _unpack(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _str(buf, pos, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    for code, fmt, read in ((0xD9, ">B", _str), (0xDA, ">H", _str),
                            (0xDB, ">I", _str), (0xDC, ">H", _array),
                            (0xDD, ">I", _array), (0xDE, ">H", _map),
                            (0xDF, ">I", _map)):
        if b == code:
            n = struct.unpack_from(fmt, buf, pos)[0]
            return read(buf, pos + struct.calcsize(fmt), n)
    raise ValueError(f"msgpack type byte {b:#x} is outside the subset")


def _str(buf, pos, n):
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _array(buf, pos, n):
    out = []
    for _ in range(n):
        x, pos = _unpack(buf, pos)
        out.append(x)
    return out, pos


def _map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


# ---- integrity ----


def _crc32_file(path: str, chunk: int = 4 * 1024 * 1024) -> int:
    """Incremental crc32 of a file (never buffers a large member)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _write_with_checksum(path: str, fname: str, data: bytes,
                         sums: dict) -> None:
    """Write one member, recording its intended crc32 (``checkpoint.save``
    ``drop``: only half the bytes land)."""
    act = fault_injection.fire("checkpoint.save", path=path, file=fname)
    sums[fname] = zlib.crc32(data)
    with open(os.path.join(path, fname), "wb") as f:
        f.write(data[: len(data) // 2] if act == "drop" else data)


def _checksum_saved_file(path: str, fname: str, sums: dict) -> None:
    """Checksum a member already streamed to disk; ``drop`` tears the
    file after the checksum recorded the whole of it."""
    act = fault_injection.fire("checkpoint.save", path=path, file=fname)
    full = os.path.join(path, fname)
    sums[fname] = _crc32_file(full)
    if act == "drop":
        with open(full, "r+b") as f:
            f.truncate(os.path.getsize(full) // 2)


def _flush_checksums(path: str, suffix: str, sums: dict) -> None:
    with open(os.path.join(path, f"checksums_{suffix}.json"), "w") as f:
        json.dump(sums, f)


def _read_checksums(path: str) -> dict[str, int]:
    """Every recorded member crc, merged across the writers' records; a
    checkpoint whose meta names more writers than left a record is
    corrupt (a lost writer would restore as zeros)."""
    if not os.path.isdir(path):
        raise CheckpointCorruptError(path, "checkpoint directory missing")
    merged: dict[str, int] = {}
    for fn in sorted(os.listdir(path)):
        if not (fn.startswith("checksums_") and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(path, fn)) as f:
                merged.update(json.load(f))
        except (ValueError, OSError) as e:
            raise CheckpointCorruptError(path, f"{fn} unreadable: {e}") from None
    meta_fn = os.path.join(path, "meta.msgpack")
    if os.path.exists(meta_fn):
        try:
            with open(meta_fn, "rb") as f:
                n_writers = int(unpackb(f.read()).get("n_writers", 0))
        except Exception as e:  # noqa: BLE001 — typed, not a traceback
            raise CheckpointCorruptError(
                path, f"meta.msgpack unreadable: {e}") from None
        lost = [k for k in range(n_writers)
                if not os.path.exists(os.path.join(path, f"checksums_p{k}.json"))]
        if lost:
            raise CheckpointCorruptError(
                path, f"writer record(s) {lost} missing ({n_writers} writers "
                      "saved)")
    return merged


def _verify_member(path: str, member: str, crc: int) -> None:
    member_path = os.path.join(path, member)
    if not os.path.exists(member_path):
        raise CheckpointCorruptError(path, f"{member} missing")
    got = _crc32_file(member_path)
    if got != crc:
        raise CheckpointCorruptError(
            path, f"{member} crc32 {got:#x} != recorded {crc:#x}")


def verify_checkpoint(path: str, members=None) -> None:
    """Check the recorded members (those of ``members`` only, if given)
    against their crc32s; raise :class:`CheckpointCorruptError` on a
    missing or mismatched file or a lost writer."""
    for member, crc in _read_checksums(path).items():
        if members is None or member in members:
            _verify_member(path, member, crc)


def verify_checkpoint_light(path: str) -> dict[str, int]:
    """Full crc32 of the small members; existence only for the
    ``shards_p*.npz`` archives, whose crcs each reader checks on its first
    read of them. Returns the merged checksum record."""
    sums = _read_checksums(path)
    for member, crc in sums.items():
        if member.startswith("shards_p"):
            if not os.path.exists(os.path.join(path, member)):
                raise CheckpointCorruptError(path, f"{member} missing")
        else:
            _verify_member(path, member, crc)
    return sums


def _fire_restore(path: str) -> None:
    """``checkpoint.restore``: ``drop`` is detected bitrot, ``die`` raises."""
    if fault_injection.fire("checkpoint.restore", path=path) == "drop":
        raise CheckpointCorruptError(path, "injected bitrot (drop)")


class Checkpoint:
    """A directory-backed checkpoint handle."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))

    @classmethod
    def from_dict(cls, data: dict, path: str | None = None) -> "Checkpoint":
        """Write ``data`` (pickled) to ``path`` (a new temporary directory
        when None) with its crc32 record."""
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        sums: dict[str, int] = {}
        _write_with_checksum(path, "user.pkl", pickle.dumps(data), sums)
        _flush_checksums(path, "d", sums)
        return cls(path)

    def to_dict(self) -> dict:
        """The dict, after its crc32 checks out (only the member read)."""
        _fire_restore(self.path)
        verify_checkpoint(self.path, members={"user.pkl"})
        with open(os.path.join(self.path, "user.pkl"), "rb") as f:
            return pickle.load(f)


# ---- tree structure, in JAX's flatten order ----


@dataclasses.dataclass(frozen=True)
class _Node:
    """A picklable tree structure: kind "dict" (keys sorted), "list",
    "tuple", "dataclass" (``cls``, children in field order), "int" (an
    int field of a dataclass: a 0-d int32 array leaf), "none" (no leaves,
    as JAX's None) or "leaf"."""

    kind: str
    children: tuple = ()
    keys: tuple = ()
    cls: Any = None

    def unflatten(self, leaves):
        """The tree with ``leaves`` in leaf order (the one call JAX's
        ``restore_state`` makes on a treedef)."""
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree has")
        return out

    def leaf_kinds(self) -> list[str]:
        """"leaf" or "int" for each leaf, in leaf order."""
        if self.kind in ("leaf", "int"):
            return [self.kind]
        return [k for c in self.children for k in c.leaf_kinds()]

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "int":
            return int(np.asarray(next(it)))
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        if self.kind == "dataclass":
            return self.cls(*kids)
        return tuple(kids) if self.kind == "tuple" else kids


_END = object()


def _is_sharding_leaf(x) -> bool:
    return isinstance(x, (NamedSharding, torch.device, str))


def _flatten(tree, *, shardings: bool = False):
    """(leaves, structure) in JAX's order. ``shardings``: ``tree`` is a
    tree of placements, whose None entries are leaves (non-array slots)."""
    leaves: list = []

    def walk(node, in_dataclass=False):
        if shardings and (node is None or _is_sharding_leaf(node)):
            leaves.append(node)
            return _Node("int" if in_dataclass and node is None else "leaf")
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return _Node("dict", tuple(walk(node[k]) for k in keys), keys)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            fields = [getattr(node, f.name) for f in dataclasses.fields(node)]
            return _Node("dataclass", tuple(walk(x, True) for x in fields),
                         cls=type(node))
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return _Node("tuple" if isinstance(node, tuple) else "list",
                         tuple(walk(x) for x in node))
        if node is None:
            return _Node("none")
        if in_dataclass and isinstance(node, int) and not isinstance(node, bool):
            leaves.append(np.asarray(node, np.int32))
            return _Node("int")
        leaves.append(node)
        return _Node("leaf")

    structure = walk(tree)
    return leaves, structure


class _JaxStub:
    """Stands in for JAX's classes when the port reads a treedef.pkl that
    JAX wrote (only its non-array leaves are used)."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return _JaxStub()

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib"):
            return _JaxStub
        return super().find_class(module, name)


def _read_treedef(path: str):
    """(the port's structure or None for JAX's, the non-array leaves)."""
    with open(os.path.join(path, "treedef.pkl"), "rb") as f:
        structure, py_leaves = _Unpickler(f).load()
    return (structure if isinstance(structure, _Node) else None), py_leaves


# ---- save ----

_NP_DTYPE = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
             torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _dtype_name(x) -> str:
    return _NP_DTYPE[x.dtype] if isinstance(x, torch.Tensor) else str(x.dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy; bf16 as its 2-byte payload (``<V2``, as
    JAX's files hold it)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _spec_of(x) -> list:
    """The PartitionSpec of a DTensor over its mesh's axis names (JAX's
    ``_spec_of``): per dim the axes that split it; trailing Nones
    trimmed. [] for a tensor on one device."""
    if not isinstance(x, DTensor):
        return []
    names = x.device_mesh.mesh_dim_names
    spec: list = [None] * x.ndim
    for mdim, p in enumerate(x.placements):
        if isinstance(p, Shard) and x.device_mesh.size(mdim) > 1:
            d = p.dim % x.ndim
            cur = spec[d]
            spec[d] = names[mdim] if cur is None else (
                (cur if isinstance(cur, list) else [cur]) + [names[mdim]])
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def _leaf_meta(x) -> dict:
    if _is_array(x):
        return {"kind": "array", "shape": list(x.shape), "dtype": _dtype_name(x),
                "spec": _spec_of(x)}
    return {"kind": "py"}


def _shards(i: int, x, pid: int):
    """(key, host array) of each distinct shard of leaf ``x`` this process
    writes: a DTensor's local block under its global offsets unless this
    rank is a non-zero replica; a plain array by process 0."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        coord = mesh.get_coordinate()
        if any(c and not (isinstance(p, Shard) and mesh.size(m) > 1)
               for m, (c, p) in enumerate(zip(coord, x.placements))):
            return
        block = local_slices(x.shape, mesh, x.placements)
        split = {p.dim % x.ndim for m, p in enumerate(x.placements)
                 if isinstance(p, Shard) and mesh.size(m) > 1}
        key = f"{i}/" + ",".join(f"{s.start}:{s.stop}" if d in split else "0:-1"
                                 for d, s in enumerate(block))
        yield key, _host(x.to_local())
    elif pid == 0:
        key = f"{i}/" + ",".join("0:-1" for _ in x.shape)
        yield key, (_host(x) if isinstance(x, torch.Tensor) else np.asarray(x))


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_state(state: Any, path: str, *, process_index: int | None = None,
               extra: dict | None = None) -> Checkpoint:
    """Collective save: every process calls this with the same ``state``
    tree and ``path``; each writes only the shards it owns (its local
    blocks, one writer per distinct shard). Process 0 writes meta, the
    structure and ``extra``. Process and writer counts come from the
    default process group (one process without one). Streams one leaf at
    a time to disk."""
    t_ckpt = time.monotonic()
    rank, world = _world()
    pid = rank if process_index is None else process_index
    os.makedirs(path, exist_ok=True)
    leaves, structure = _flatten(state)
    sums: dict[str, int] = {}
    n_shards = 0
    shard_fn = f"shards_p{pid}.npz"
    with zipfile.ZipFile(os.path.join(path, shard_fn), "w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            if not _is_array(leaf):
                continue
            for key, arr in _shards(i, leaf, pid):
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                n_shards += 1
    _checksum_saved_file(path, shard_fn, sums)
    if pid == 0:
        meta = {"leaves": [_leaf_meta(x) for x in leaves],
                "n_leaves": len(leaves), "n_writers": world}
        _write_with_checksum(path, "meta.msgpack", packb(meta), sums)
        _write_with_checksum(path, "treedef.pkl", pickle.dumps(
            (structure, [None if _is_array(x) else x for x in leaves])), sums)
        if extra is not None:
            _write_with_checksum(path, "user.pkl", pickle.dumps(extra), sums)
    _flush_checksums(path, f"p{pid}", sums)
    t_done = time.monotonic()
    _sess._add_step_time("checkpoint", t_done - t_ckpt)
    _sess._record("train", "train.checkpoint_save", t_ckpt, t_done,
                  {"path": path, "process": pid, "shards": n_shards})
    return Checkpoint(path)


# ---- restore ----


class _ShardReader:
    """Lazy index over a checkpoint's shards_p*.npz files: indexing the
    member names reads nothing, and ``load`` reads exactly one member
    (the shard-local property). ``bytes_read`` counts what was read."""

    def __init__(self, path: str, sums: dict[str, int] | None = None):
        self._path = path
        self._zips = {}
        self._sums = sums or {}
        self._verified: set[str] = set()
        self.by_leaf: dict[int, list[tuple[str, str, str]]] = {}
        self.bytes_read = 0
        for fn in sorted(os.listdir(path)):
            if not fn.startswith("shards_p"):
                continue
            try:
                z = np.load(os.path.join(path, fn))
            except Exception as e:  # noqa: BLE001 — BadZipFile, OSError, ...
                raise CheckpointCorruptError(
                    path, f"{fn} unreadable: {type(e).__name__}: {e}") from None
            self._zips[fn] = z
            for key in z.files:
                leaf_i, _, idx = key.partition("/")
                self.by_leaf.setdefault(int(leaf_i), []).append((idx, fn, key))

    def load(self, fn: str, key: str) -> np.ndarray:
        """One member; its archive's crc32 is checked on its first read."""
        if fn in self._sums and fn not in self._verified:
            _verify_member(self._path, fn, self._sums[fn])
            self._verified.add(fn)
        arr = self._zips[fn][key]
        self.bytes_read += arr.nbytes
        return arr

    def close(self):
        for z in self._zips.values():
            z.close()


def _parse_idx(idx_key: str, shape) -> tuple[slice, ...]:
    if not idx_key:
        return tuple(slice(0, d) for d in shape)
    slices = []
    for d, part in zip(shape, idx_key.split(",")):
        a, _, b = part.partition(":")
        slices.append(slice(int(a), d if b == "-1" else int(b)))
    return tuple(slices)


def _norm_index(index, shape) -> tuple[tuple[int, int], ...]:
    return tuple((0 if sl.start is None else sl.start,
                  d if sl.stop is None else sl.stop)
                 for d, sl in zip(shape, index))


def _storage_dtype(dtype) -> np.dtype:
    """How a leaf of ``dtype`` (a name or numpy dtype) lies in the file:
    bf16 as 2-byte words."""
    return np.dtype(np.uint16) if str(dtype) == "bfloat16" else np.dtype(dtype)


def _load_device_shard(reader: _ShardReader, leaf_i: int, shape, dtype,
                       index) -> np.ndarray:
    """One block of a leaf, reading only the pieces that cover it: the
    saved piece itself when the layouts match, else assembled from the
    overlapping pieces (a reshaped mesh). bf16 comes back as uint16."""
    store = _storage_dtype(dtype)
    want = _norm_index(index, shape)
    pieces = reader.by_leaf.get(leaf_i, [])
    for idx_key, fn, key in pieces:
        if _norm_index(_parse_idx(idx_key, shape), shape) == want:
            return reader.load(fn, key).view(store)
    out = np.zeros([b - a for a, b in want], dtype=store)
    for idx_key, fn, key in pieces:
        have = _norm_index(_parse_idx(idx_key, shape), shape)
        inter = [(max(a1, a2), min(b1, b2))
                 for (a1, b1), (a2, b2) in zip(want, have)]
        if any(a >= b for a, b in inter):
            continue
        data = reader.load(fn, key).view(store)
        src = tuple(slice(a - ha, b - ha) for (a, b), (ha, _) in zip(inter, have))
        dst = tuple(slice(a - wa, b - wa) for (a, b), (wa, _) in zip(inter, want))
        out[dst] = data[src]
    return out


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _mesh_device(mesh) -> torch.device:
    dev = resolve_device(mesh.device_type)
    return torch.device("cuda", torch.cuda.current_device()) \
        if dev.type == "cuda" else dev


def _placement_of(x):
    """A ``like`` leaf's placement: its NamedSharding or its device."""
    if isinstance(x, DTensor):
        return NamedSharding(x.device_mesh, tuple(x.placements))
    if isinstance(x, torch.Tensor):
        return x.device
    return None


def restore_state(path: str, mesh=None, shardings=None, *, like=None,
                  device=None, stats: dict | None = None) -> Any:
    """Restore a checkpoint onto this process's devices, reading only the
    bytes that cover its own blocks (at N processes each reads ~1/N).

    Each array leaf goes where its entry of ``shardings`` says (a tree
    like the state's with ``NamedSharding``s, devices, or None for a
    non-array slot, as ``init_train_state`` returns); or where its
    ``like`` leaf lies; else under the spec recorded at save time on
    ``mesh``; else whole on ``device`` (default ``cuda``; raises without
    a card). A saved layout that differs from the target (a reshaped
    mesh) is assembled from the overlapping pieces. A checkpoint that
    JAX wrote needs ``shardings`` or ``like`` for its structure. ``stats``
    receives {"bytes_read": N}."""
    _fire_restore(path)
    sums = verify_checkpoint_light(path)
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = unpackb(f.read())
    structure, py_leaves = _read_treedef(path)
    targets = None
    if shardings is not None:
        targets, given = _flatten(shardings, shardings=True)
    elif like is not None:
        like_leaves, given = _flatten(like)
        targets = [_placement_of(x) for x in like_leaves]
    if structure is None:
        if targets is None:
            raise ValueError(f"{path} was written by the JAX package: pass "
                             "shardings= or like= for its tree structure")
        structure = given
    n = len(meta["leaves"])
    if targets is not None and len(targets) != n:
        raise ValueError(f"shardings tree has {len(targets)} leaves; "
                         f"checkpoint has {n}")
    kinds = structure.leaf_kinds()
    reader = _ShardReader(path, sums)
    try:
        leaves = []
        for i, lm in enumerate(meta["leaves"]):
            if lm["kind"] != "array":
                leaves.append(py_leaves[i])
                continue
            shape, dtype = tuple(lm["shape"]), lm["dtype"]
            if kinds[i] == "int":  # a step counter: back to an int
                leaves.append(_load_device_shard(reader, i, shape, dtype, ()))
                continue
            target = targets[i] if targets is not None else None
            if target is None and mesh is not None:
                spec = tuple(tuple(p) if isinstance(p, list) else p
                             for p in lm["spec"])
                target = NamedSharding(active_mesh(mesh),
                                       spec_to_placements(spec, mesh))
            if isinstance(target, NamedSharding):
                block = local_slices(shape, *target)
                local = _tensor(_load_device_shard(reader, i, shape, dtype, block),
                                dtype, _mesh_device(target.mesh))
                leaves.append(DTensor.from_local(
                    local, target.mesh, target.placements, run_check=False,
                    shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride()))
            else:
                dev = resolve_device(device if target is None else target)
                full = tuple(slice(0, d) for d in shape)
                leaves.append(_tensor(_load_device_shard(reader, i, shape, dtype,
                                                         full), dtype, dev))
        if stats is not None:
            stats["bytes_read"] = reader.bytes_read
        return structure.unflatten(leaves)
    finally:
        reader.close()


def ship_checkpoint(ckpt: "Checkpoint | str", *, runtime=None,
                    wait_clearance=None) -> Any:
    """Ship a checkpoint directory through the runtime's object store.

    Returns a ref (``runtime.put``'s) whose value is ``{"dir": basename,
    "members": {fname: uint8 array}}``. Members are mapped, so the put
    reads page cache directly; the put owns its bytes (``owned=True``:
    a store copies them, the in-process runtime copies each member), so
    the maps are closed right after it and the ref outlives the
    directory. ``wait_clearance``, when given, is called first: a hosting
    runtime's overload guardian holds bulk transfers with it (JAX calls
    ``ray_tpu.serve.overload.wait_bulk_clearance``); None waits for
    nothing, as in process.
    """
    import mmap

    if wait_clearance is not None:
        wait_clearance()
    rt = runtime or _in_process_runtime()
    path = ckpt.path if isinstance(ckpt, Checkpoint) else \
        os.path.abspath(ckpt)
    if not os.path.isdir(path):
        raise CheckpointCorruptError(path, "checkpoint directory missing")
    members: dict[str, Any] = {}
    maps = []
    try:
        for fn in sorted(os.listdir(path)):
            full = os.path.join(path, fn)
            if not os.path.isfile(full):
                continue
            if os.path.getsize(full) == 0:
                members[fn] = np.empty(0, dtype=np.uint8)
                continue
            f = open(full, "rb")  # noqa: SIM115 — lifetime spans the put
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            maps.append((f, mm))
            members[fn] = np.frombuffer(mm, dtype=np.uint8)
        return rt.put({"dir": os.path.basename(path), "members": members},
                      owned=True)
    finally:
        members.clear()  # release the map views before closing
        for f, mm in maps:
            try:
                mm.close()
            except BufferError:
                pass  # a straggler view pins pages until gc; harmless
            f.close()


def fetch_checkpoint(ref: Any, dest_root: str, *, runtime=None,
                     timeout: float = 600.0) -> Checkpoint:
    """Materialize a shipped checkpoint under ``dest_root``.

    The get carries ``fetch_tags={"qos": "bulk", "owner": "checkpoint"}``
    (JAX's ``fetch_context``), so a hosting runtime attributes the
    transfer to the checkpoint consumer; writing the members out is the
    only copy after it. Verifies integrity before returning."""
    rt = runtime or _in_process_runtime()
    blob = rt.get(ref, timeout=timeout,
                  fetch_tags={"qos": "bulk", "owner": "checkpoint"})
    path = os.path.join(os.path.abspath(dest_root), blob["dir"])
    os.makedirs(path, exist_ok=True)
    for fn, arr in blob["members"].items():
        with open(os.path.join(path, fn), "wb") as f:
            f.write(memoryview(np.ascontiguousarray(arr)))
    verify_checkpoint(path)
    return Checkpoint(path)


def _in_process_runtime():
    from ray_tpu_torch.serve.runtime import InProcessRuntime

    return InProcessRuntime()


class CheckpointManager:
    """Retention and ranking of a run's checkpoints."""

    def __init__(self, root: str, num_to_keep: int = 2,
                 score_attr: str | None = None, score_order: str = "max"):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attr = score_attr
        self.score_order = score_order
        # (score, seq, path): seq is registration order, the tiebreaker for
        # `best` and the sole key for `latest`
        self._registered: list[tuple[float, int, str]] = []
        self._seq = 0

    def next_dir(self) -> str:
        return os.path.join(self.root, f"checkpoint_{self._seq + 1:06d}")

    def register(self, ckpt: Checkpoint, metrics: dict | None = None):
        self._seq += 1
        score = float(self._seq)
        if self.score_attr and metrics and self.score_attr in metrics:
            score = float(metrics[self.score_attr])
            if self.score_order == "min":
                score = -score
        self._registered.append((score, self._seq, ckpt.path))
        self._registered.sort()
        while len(self._registered) > self.num_to_keep:
            _, _, worst = self._registered.pop(0)
            shutil.rmtree(worst, ignore_errors=True)

    @property
    def best(self) -> Checkpoint | None:
        if not self._registered:
            return None
        return Checkpoint(self._registered[-1][2])

    @property
    def latest(self) -> Checkpoint | None:
        if not self._registered:
            return None
        return Checkpoint(max(self._registered, key=lambda t: t[1])[2])

    def owns(self, ckpt: "Checkpoint | str") -> bool:
        """Whether this manager registered the checkpoint (the guard that
        keeps :meth:`discard` off paths the user owns)."""
        path = ckpt.path if isinstance(ckpt, Checkpoint) else os.path.abspath(ckpt)
        return any(t[2] == path for t in self._registered)

    def discard(self, ckpt: "Checkpoint | str") -> None:
        """Drop a (corrupt) checkpoint from the registry and the disk."""
        path = ckpt.path if isinstance(ckpt, Checkpoint) else os.path.abspath(ckpt)
        self._registered = [t for t in self._registered if t[2] != path]
        shutil.rmtree(path, ignore_errors=True)

    def latest_valid(self, *, full: bool = True) -> Checkpoint | None:
        """Newest checkpoint that passes verification, discarding corrupt
        ones on the way down; ``full=False`` runs the light check."""
        while True:
            c = self.latest
            if c is None:
                return None
            try:
                if full:
                    verify_checkpoint(c.path)
                else:
                    verify_checkpoint_light(c.path)
                return c
            except CheckpointCorruptError as e:
                logger.warning("discarding corrupt checkpoint: %s", e)
                self.discard(c)

    def latest_dict(self) -> dict | None:
        """Payload of the newest dict checkpoint, or None."""
        c = self.latest
        return None if c is None else c.to_dict()
