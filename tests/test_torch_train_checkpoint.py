"""The port's train-state checkpoints against the JAX package's.

The shard-local cases of tests/test_checkpoint_shardlocal.py run in 8
gloo ranks (``launch.spawn``), each a process of a dp=8 mesh that saves
its own shard, so the writers are real; a checkpoint JAX wrote on 8
virtual CPU devices is restored both in those ranks (each reading its
piece) and in this process; one the port wrote is restored by JAX on the
8 devices. Leaves must be bit-equal across the packages in f32 and int.
The integrity cases of tests/test_train_elastic.py (torn write, bitrot,
checksummed sharded save, truncated archive, lost writer) run on the
port. Also: meta.msgpack byte for byte what ``msgpack.packb`` gives of
JAX's meta, bf16 round trips in the port, and the JAX package's own bf16
restore, which raises (a defect of the reference, pinned here).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.train import checkpoint as jck
from ray_tpu.train import step as jstep
from ray_tpu.train.optim import FusedAdamWState as JFusedAdamWState
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.train import checkpoint as ck
from ray_tpu_torch.train import fault_injection as fi
from ray_tpu_torch.train.optim import FusedAdamWState
from ray_tpu_torch.train.step import TrainState

import test_torch_dist_ranks as ranks

W_SHAPE = (8 * 16, 24)


def _jax_state(rs):
    """A JAX train state (step, params, opt_state) with f32, int32 and
    bf16 leaves, and the same values as numpy (bf16 as float32)."""
    params = {"b": rs.randn(24).astype(np.float32),
              "w": rs.randn(*W_SHAPE).astype(np.float32),
              "ids": rs.randint(-9, 9, (5, 3)).astype(np.int32)}
    mu = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    return params, mu


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of 8 gloo ranks runs every shard-local case; JAX wrote the
    checkpoint they restore, {"w": f32 sharded over dp, "b": replicated}."""
    tmp = tmp_path_factory.mktemp("ckworld")
    mesh = jbuild_mesh(JMeshConfig(dp=8), jax.devices()[:8])
    w = np.random.RandomState(0).randn(*W_SHAPE).astype(np.float32)
    b = np.arange(24, dtype=np.float32)
    jck.save_state({"w": jax.device_put(w, JNamedSharding(mesh, P("dp"))),
                    "b": jax.device_put(b, JNamedSharding(mesh, P()))},
                   str(tmp / "jax"))
    outs = launch.spawn(ranks.checkpoint_rank, 8, str(tmp / "port"),
                        str(tmp / "jax"), w, device="cpu", timeout_s=300)
    return outs, w, b, tmp


def _case(world, name):
    outs = world[0]
    for r in outs:
        assert "error" not in r[name], r[name]["error"]
    return [r[name] for r in outs]


def test_save_restore_roundtrip_sharded(world):
    big = np.arange(8 * 64 * 32, dtype=np.float32).reshape(8 * 64, 32)
    for rank, got in enumerate(_case(world, "roundtrip")):
        np.testing.assert_array_equal(got["w"], big)
        assert got["step"] == 7 and got["scalar"] == 3.5
        assert got["local_shape"] == [64, 32]
        # each process reads its own eighth of w, and the scalar once
        assert got["bytes_read"] == big.nbytes // 8 + 4
        assert [f for f in got["files"] if f.startswith("shards_p")] == \
            [f"shards_p{k}.npz" for k in range(8)]


def test_per_process_read_fraction(world):
    big = np.arange(8 * 64 * 32, dtype=np.float32).reshape(8 * 64, 32)
    for rank, got in enumerate(_case(world, "read_fraction")):
        assert got["shape"] == [64, 32]
        assert got["bytes_read"] == got["nbytes"] // 8
        np.testing.assert_array_equal(got["block"], big[64 * rank:64 * (rank + 1)])


def test_restore_onto_reshaped_mesh(world):
    big = np.arange(8 * 16 * 64, dtype=np.float32).reshape(8 * 16, 64)
    for got in _case(world, "reshaped"):
        np.testing.assert_array_equal(got["w"], big)
        assert got["placements"] == ["S(0)", "S(1)"]
        assert got["local_shape"] == [32, 32]


def test_multi_writer_files_cover(world):
    for got in _case(world, "writers_cover"):
        np.testing.assert_array_equal(got["v"], np.arange(64, dtype=np.int32))
        assert got["n_writers"] == 8
        assert {f"checksums_p{k}.json" for k in range(8)} <= set(got["files"])


def test_jax_sharded_checkpoint_restores_shard_locally(world):
    _, w, b, _ = world
    for got in _case(world, "jax_written"):
        np.testing.assert_array_equal(got["w_block"], got["want_block"])
        np.testing.assert_array_equal(got["b"], b)
        assert got["bytes_read"] == w.nbytes // 8 + b.nbytes


def test_port_sharded_checkpoint_restores_in_jax(world):
    """The 8-writer checkpoints the ranks wrote, restored by JAX's own
    restore_state on 8 devices under the specs recorded at save time."""
    tmp = world[3]
    mesh = jbuild_mesh(JMeshConfig(dp=8), jax.devices()[:8])
    got = jck.restore_state(str(tmp / "port" / "roundtrip"), mesh=mesh)
    np.testing.assert_array_equal(
        np.asarray(got["w"]),
        np.arange(8 * 64 * 32, dtype=np.float32).reshape(8 * 64, 32))
    assert got["w"].sharding.spec == P("dp")
    assert got["step"] == 7 and float(got["scalar"]) == 3.5
    got = jck.restore_state(str(tmp / "port" / "cover"), mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got["v"]), np.arange(64))


@pytest.fixture
def jax_and_port(tmp_path):
    """The same train state written by both packages, one device each:
    TrainState(step, params, FusedAdamWState(count, mu, nu)) with f32 and
    int32 leaves."""
    params, mu = _jax_state(np.random.RandomState(1))
    nu = {k: np.abs(v) for k, v in mu.items()}
    jstate = jstep.TrainState(
        jnp.int32(3), {k: jnp.asarray(v) for k, v in params.items()},
        JFusedAdamWState(jnp.int32(3), {k: jnp.asarray(v) for k, v in mu.items()},
                         {k: jnp.asarray(v) for k, v in nu.items()}))
    tstate = TrainState(3, {k: torch.from_numpy(v) for k, v in params.items()},
                        FusedAdamWState(3, {k: torch.from_numpy(v) for k, v in mu.items()},
                                        {k: torch.from_numpy(v) for k, v in nu.items()}))
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_state(jstate, jpath, extra={"note": "x"})
    ck.save_state(tstate, tpath, extra={"note": "x"})
    return jstate, tstate, jpath, tpath


def test_meta_bytes_equal_msgpack_of_jax_meta(jax_and_port):
    _, _, jpath, tpath = jax_and_port
    with open(os.path.join(jpath, "meta.msgpack"), "rb") as f:
        jax_bytes = f.read()
    with open(os.path.join(tpath, "meta.msgpack"), "rb") as f:
        port_bytes = f.read()
    assert port_bytes == jax_bytes
    meta = msgpack.unpackb(jax_bytes)
    assert ck.packb(meta) == msgpack.packb(meta) == jax_bytes
    assert ck.unpackb(jax_bytes) == meta


@pytest.mark.parametrize("obj", [
    {"a": [1, -1, -33, 127, 128, 255, 256, 65535, 65536, 2**32, -128, -129,
           -2**15 - 1, -2**31 - 1, None, True, False]},
    {"s": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é" * 40000]},
    {str(i): list(range(i)) for i in range(20)},
    {"deep": [[[]]] * 16 + [{}] * 3},
])
def test_packb_matches_msgpack(obj):
    assert ck.packb(obj) == msgpack.packb(obj)
    assert ck.unpackb(ck.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))


def test_shard_members_equal_across_packages(jax_and_port):
    """Same member keys, headers and bytes in both packages' archives."""
    _, _, jpath, tpath = jax_and_port
    zj = np.load(os.path.join(jpath, "shards_p0.npz"))
    zt = np.load(os.path.join(tpath, "shards_p0.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for key in zj.files:
        assert zj[key].dtype == zt[key].dtype and zj[key].shape == zt[key].shape
        np.testing.assert_array_equal(zj[key], zt[key])


def test_jax_checkpoint_restores_in_port_leaf_for_leaf(jax_and_port):
    jstate, tstate, jpath, _ = jax_and_port
    like = TrainState(0, {k: torch.zeros_like(v) for k, v in tstate.params.items()},
                      FusedAdamWState(0, {k: torch.zeros_like(v) for k, v in
                                          tstate.opt_state.mu.items()},
                                      {k: torch.zeros_like(v) for k, v in
                                       tstate.opt_state.nu.items()}))
    with pytest.raises(ValueError, match="JAX package"):
        ck.restore_state(jpath, device="cpu")
    got = ck.restore_state(jpath, like=like)
    assert isinstance(got, TrainState) and got.step == 3 and got.opt_state.count == 3
    for tree, jtree in ((got.params, jstate.params),
                        (got.opt_state.mu, jstate.opt_state.mu),
                        (got.opt_state.nu, jstate.opt_state.nu)):
        for k in jtree:
            assert tree[k].numpy().dtype == np.asarray(jtree[k]).dtype
            np.testing.assert_array_equal(tree[k].numpy(), np.asarray(jtree[k]))
    # the shardings form: None for the step slots, devices for the leaves
    sh = TrainState(None, {k: "cpu" for k in tstate.params},
                    FusedAdamWState(None, {k: "cpu" for k in tstate.params},
                                    {k: "cpu" for k in tstate.params}))
    got2 = ck.restore_state(jpath, shardings=sh)
    assert got2.step == 3
    np.testing.assert_array_equal(got2.params["w"].numpy(),
                                  np.asarray(jstate.params["w"]))
    assert ck.Checkpoint(jpath).to_dict() == {"note": "x"}


def test_port_checkpoint_restores_in_jax(jax_and_port):
    jstate, _, _, tpath = jax_and_port
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    got = jck.restore_state(tpath, mesh=None, shardings=jstep.TrainState(
        one, {k: one for k in jstate.params},
        JFusedAdamWState(one, *[{k: one for k in jstate.params}] * 2)))
    assert got.step == 3 and got.opt_state.count == 3
    for tree, jtree in ((got.params, jstate.params),
                        (got.opt_state.mu, jstate.opt_state.mu),
                        (got.opt_state.nu, jstate.opt_state.nu)):
        for k in jtree:
            assert np.asarray(tree[k]).dtype == np.asarray(jtree[k]).dtype
            np.testing.assert_array_equal(np.asarray(tree[k]), np.asarray(jtree[k]))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 2)])
def test_bf16_round_trips_in_the_port(tmp_path, shape):
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(shape, generator=g) * 100).to(torch.bfloat16)
    state = TrainState(9, {"m": x, "f": torch.ones(2)},
                       FusedAdamWState(9, {"m": x * 2}, {"m": x.abs()}))
    path = str(tmp_path / "bf")
    ck.save_state(state, path)
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = ck.unpackb(f.read())
    assert [m["dtype"] for m in meta["leaves"]] == \
        ["int32", "float32", "bfloat16", "int32", "bfloat16", "bfloat16"]
    assert np.load(os.path.join(path, "shards_p0.npz"))["2/" + ",".join(
        "0:-1" for _ in shape)].dtype == np.dtype("V2")
    got = ck.restore_state(path, device="cpu")
    for a, b in ((got.params["m"], x), (got.opt_state.mu["m"], x * 2),
                 (got.opt_state.nu["m"], x.abs())):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    """JAX's own bf16 leaf (written as <V2) restores in the port, bit for
    bit."""
    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    path = str(tmp_path / "jbf")
    jck.save_state({"m": xb}, path)
    got = ck.restore_state(path, like={"m": torch.zeros(4, 6, dtype=torch.bfloat16)})
    want = torch.from_numpy(np.array(xb).view(np.int16))
    assert got["m"].dtype == torch.bfloat16
    assert torch.equal(got["m"].view(torch.int16), want)


def test_jax_cannot_restore_its_own_bf16_leaf(tmp_path):
    """Reference defect, pinned: JAX's save_state writes a bf16 leaf as
    numpy's <V2 and its restore_state hands that to jax.device_put, which
    refuses it. The port restores it (test above)."""
    path = str(tmp_path / "jbf")
    jck.save_state({"m": jnp.zeros(8, jnp.bfloat16)}, path)
    with pytest.raises(TypeError, match="V2"):
        jck.restore_state(path, mesh=None, shardings={
            "m": jax.sharding.SingleDeviceSharding(jax.devices()[0])})


# --------------------------------------------------------------------------
# integrity: torn writes, bitrot, truncated archives, lost writers
# (tests/test_train_elastic.py's cases, on the port)
# --------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _clear_faults():
    fi.clear()
    yield
    fi.clear()


def test_torn_checkpoint_write_is_typed_and_falls_back(tmp_path):
    good = ck.Checkpoint.from_dict({"step": 1}, str(tmp_path / "good"))
    fi.configure([{"site": "checkpoint.save", "action": "drop"}])
    torn = ck.Checkpoint.from_dict({"step": 2}, str(tmp_path / "torn"))
    fi.clear()
    with pytest.raises(ck.CheckpointCorruptError, match="crc32"):
        torn.to_dict()
    mgr = ck.CheckpointManager(str(tmp_path / "mgr"))
    mgr.register(good)
    mgr.register(torn)
    assert mgr.latest.path == torn.path
    lv = mgr.latest_valid()
    assert lv is not None and lv.path == good.path
    assert mgr.latest.path == good.path
    assert lv.to_dict() == {"step": 1}


def test_injected_bitrot_on_restore_is_typed(tmp_path):
    c = ck.Checkpoint.from_dict({"step": 3}, str(tmp_path / "ck"))
    fi.configure([{"site": "checkpoint.restore", "action": "drop"}])
    with pytest.raises(ck.CheckpointCorruptError, match="bitrot"):
        c.to_dict()
    assert c.to_dict() == {"step": 3}  # count=1: the checkpoint is intact


def _restore_w(path):
    return ck.restore_state(path, shardings={"w": "cpu", "step": None})


def test_sharded_save_is_checksummed(tmp_path):
    path = str(tmp_path / "sck")
    ck.save_state({"w": torch.arange(8.0), "step": 1}, path, extra={"tag": "x"})
    ck.verify_checkpoint(path)
    got = _restore_w(path)
    np.testing.assert_allclose(got["w"].numpy(), np.arange(8.0))
    assert got["step"] == 1
    with open(os.path.join(path, "shards_p0.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff")
    with pytest.raises(ck.CheckpointCorruptError):
        _restore_w(path)


def test_truncated_shard_archive_is_typed(tmp_path):
    path = str(tmp_path / "tck")
    ck.save_state({"w": torch.arange(8.0)}, path)
    shard_file = os.path.join(path, "shards_p0.npz")
    with open(shard_file, "r+b") as f:
        f.truncate(os.path.getsize(shard_file) - 30)
    with pytest.raises(ck.CheckpointCorruptError, match="unreadable"):
        ck.restore_state(path, shardings={"w": "cpu"})


def test_missing_writer_record_is_typed(tmp_path):
    path = str(tmp_path / "wck")
    ck.save_state({"w": torch.arange(8.0)}, path)
    os.remove(os.path.join(path, "shards_p0.npz"))
    os.remove(os.path.join(path, "checksums_p0.json"))
    with pytest.raises(ck.CheckpointCorruptError, match="writer record"):
        ck.verify_checkpoint(path)
    with pytest.raises(ck.CheckpointCorruptError, match="writer record"):
        ck.restore_state(path, shardings={"w": "cpu"})


def test_torn_sharded_save_falls_back_in_the_manager(tmp_path):
    """A torn shard archive (checkpoint.save drop on the streamed member)
    is caught by the manager's full verify; the older one is kept."""
    mgr = ck.CheckpointManager(str(tmp_path / "mgr"))
    good = ck.save_state({"w": torch.ones(4)}, mgr.next_dir())
    mgr.register(good)
    fi.configure([{"site": "checkpoint.save", "match": {"file": "shards_p0.npz"},
                   "action": "drop"}])
    torn = ck.save_state({"w": torch.zeros(4)}, mgr.next_dir())
    mgr.register(torn)
    assert mgr.latest_valid().path == good.path
    with open(os.path.join(good.path, "treedef.pkl"), "rb") as f:
        structure, py = pickle.load(f)
    assert structure.kind == "dict" and py == [None]
