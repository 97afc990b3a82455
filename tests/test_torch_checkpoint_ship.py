"""The port's ship_checkpoint / fetch_checkpoint on the CPU.

A checkpoint written by the port's ``save_state`` and one written by
JAX's go through the port's ``ship_checkpoint`` (the in-process
runtime's ``put(owned=True)``), their source directories are deleted,
and the port's ``fetch_checkpoint`` writes them under a new root: every
member byte-equal to a copy taken before the ship, ``verify_checkpoint``
passes, and the restored state equals the saved one (JAX's given its
structure). The transfer carries the checkpoint's fetch tags, the
clearance wait runs before the put, and a missing directory raises as
JAX's does.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.train import checkpoint as j_ckpt
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.train import checkpoint as t_ckpt


def _members(path):
    out = {}
    for fn in sorted(os.listdir(path)):
        with open(os.path.join(path, fn), "rb") as f:
            out[fn] = f.read()
    return out


class RecordingRuntime(InProcessRuntime):
    """The in-process runtime, keeping the tags and options of its puts
    and gets."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def put(self, tree, *, owned=False):
        self.calls.append(("put", owned))
        return super().put(tree, owned=owned)

    def get(self, refs, timeout=None, fetch_tags=None):
        self.calls.append(("get", fetch_tags))
        return super().get(refs, timeout=timeout, fetch_tags=fetch_tags)


def _port_state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(64, 32, generator=g),
            "h": torch.randn(16, generator=g).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}


def test_port_checkpoint_round_trips_after_the_source_is_gone(tmp_path):
    state = _port_state()
    src = str(tmp_path / "run" / "ck_3")
    t_ckpt.save_state(state, src, extra={"cursor": [1, 2]})
    want = _members(src)
    rt = RecordingRuntime()
    cleared = []
    ref = t_ckpt.ship_checkpoint(t_ckpt.Checkpoint(src), runtime=rt,
                                 wait_clearance=lambda: cleared.append(
                                     len(rt.calls)))
    shutil.rmtree(tmp_path / "run")
    got = t_ckpt.fetch_checkpoint(ref, str(tmp_path / "fetched"), runtime=rt)
    assert got.path == str(tmp_path / "fetched" / "ck_3")
    assert _members(got.path) == want
    t_ckpt.verify_checkpoint(got.path)
    back = t_ckpt.restore_state(got.path, device="cpu")
    for k in state:
        assert torch.equal(back[k], state[k]), k
    assert cleared == [0]  # the wait ran before the put
    assert rt.calls == [("put", True),
                        ("get", {"qos": "bulk", "owner": "checkpoint"})]


def test_jax_checkpoint_ships_through_the_port(tmp_path):
    """JAX's save_state writes; the port ships it, the source goes, the
    port fetches (default runtime: in process) and restores the fetched
    copy equal (JAX's structure from ``like``)."""
    state = {"a": jnp.arange(12.0).reshape(3, 4),
             "b": {"c": jnp.ones((5,), jnp.int32) * 7}}
    src = str(tmp_path / "jax_ck")
    j_ckpt.save_state(state, src)
    want = _members(src)
    ref = t_ckpt.ship_checkpoint(src)
    shutil.rmtree(src)
    got = t_ckpt.fetch_checkpoint(ref, str(tmp_path / "dest"))
    assert _members(got.path) == want
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.int32)}}
    back = t_ckpt.restore_state(got.path, like=like)
    for x, y in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, state)),
            [back["a"], back["b"]["c"]]):
        np.testing.assert_array_equal(y.numpy(), x)


def test_owned_put_copies_and_plain_put_does_not():
    rt = InProcessRuntime()
    buf = bytearray(b"abcdef")
    view = np.frombuffer(buf, np.uint8)
    tree = {"m": {"x": view}, "l": [view[:2]], "s": "keep"}
    owned, plain = rt.put(tree, owned=True), rt.put(tree)
    buf[0] = ord("z")
    assert bytes(owned["m"]["x"]) == b"abcdef"
    assert bytes(owned["l"][0]) == b"ab"
    assert bytes(plain["m"]["x"]) == b"zbcdef"
    assert owned["s"] == "keep" and rt.get(owned) is owned


def test_empty_members_and_a_missing_directory(tmp_path):
    src = tmp_path / "c"
    t_ckpt.Checkpoint.from_dict({"k": 1}, str(src))
    (src / "empty.txt").write_bytes(b"")
    ref = t_ckpt.ship_checkpoint(str(src))
    assert ref["members"]["empty.txt"].size == 0
    shutil.rmtree(src)
    got = t_ckpt.fetch_checkpoint(ref, str(tmp_path / "d"))
    assert got.to_dict() == {"k": 1}
    assert os.path.getsize(os.path.join(got.path, "empty.txt")) == 0
    with pytest.raises(t_ckpt.CheckpointCorruptError, match="missing"):
        t_ckpt.ship_checkpoint(str(tmp_path / "nope"))
