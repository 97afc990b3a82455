"""Dict checkpoints with crc32 integrity: the part the MPMD stage loop needs.

The port's own copy of the dict form of ray_tpu/train/checkpoint.py
(``CheckpointCorruptError``, the crc32 helpers, ``Checkpoint.from_dict``
and ``to_dict``), in the same format, so a checkpoint written by either
package reads in the other. One directory per checkpoint:

    user.pkl              the pickled dict
    checksums_d.json      {"user.pkl": crc32 of the bytes written}

A read verifies the recorded crc32 before it unpickles, so a torn or
altered file raises :class:`CheckpointCorruptError` (the pipeline then
resumes from an older checkpoint) instead of a pickle traceback. The
sharded ``save_state`` / ``restore_state`` of the JAX package are not
ported here.
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
import zlib


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (missing file, crc32
    mismatch, unreadable checksum record)."""

    def __init__(self, path: str, detail: str):
        self.path = path
        self.detail = detail
        super().__init__(f"corrupt checkpoint at {path}: {detail}")


def _crc32_file(path: str, chunk: int = 4 * 1024 * 1024) -> int:
    """Incremental crc32 of a file."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _read_checksums(path: str) -> dict[str, int]:
    """Every recorded member crc, merged across the writers' records."""
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
    return merged


def verify_checkpoint(path: str, members=None) -> None:
    """Check the recorded members (those of ``members`` only, if given)
    against their crc32s; raise :class:`CheckpointCorruptError` on a
    missing or mismatched file."""
    for member, crc in _read_checksums(path).items():
        if members is not None and member not in members:
            continue
        member_path = os.path.join(path, member)
        if not os.path.exists(member_path):
            raise CheckpointCorruptError(path, f"{member} missing")
        got = _crc32_file(member_path)
        if got != crc:
            raise CheckpointCorruptError(
                path, f"{member} crc32 {got:#x} != recorded {crc:#x}")


class Checkpoint:
    """A directory-backed checkpoint handle."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def __repr__(self):
        return f"Checkpoint({self.path})"

    @classmethod
    def from_dict(cls, data: dict, path: str | None = None) -> "Checkpoint":
        """Write ``data`` (pickled) to ``path`` (a new temporary directory
        when None) with its crc32 record."""
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        payload = pickle.dumps(data)
        with open(os.path.join(path, "user.pkl"), "wb") as f:
            f.write(payload)
        with open(os.path.join(path, "checksums_d.json"), "w") as f:
            json.dump({"user.pkl": zlib.crc32(payload)}, f)
        return cls(path)

    def to_dict(self) -> dict:
        """The dict, after its crc32 checks out (only the member read)."""
        verify_checkpoint(self.path, members={"user.pkl"})
        with open(os.path.join(self.path, "user.pkl"), "rb") as f:
            return pickle.load(f)
