"""The port's ring collectives (``ray_tpu_torch/collective/ring.py`` and
``collective.py``) bit for bit against the JAX package's.

JAX's ranks run as threads over tests/test_collective_ring.py's fake
group (imported; every frame goes through its wire serialization); the
port's run as threads of its own ``Group`` over a ``LocalFabric``. On the
same seeded payloads, ``ring_allreduce`` and ``ring_reducescatter`` give
the same bits at world 1, 2, 3 and 8 for f32, int32 and bf16, codec
none, bf16 and int8, op sum, mean, max and min; ``ring_allgather`` over
the same worlds, dtypes and codecs; two chunk sizes; 3 successive
error-feedback calls. The ``OpStats`` wire and logical bytes equal
JAX's rank by rank, and the star transport equals JAX's
``_star_allreduce``. JAX's bf16 payloads are ``ml_dtypes`` arrays; the
port's are ``torch.bfloat16`` tensors of the same bits.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.collective import collective as jcol
from ray_tpu.collective import ring as jring
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.collective import ring

from test_collective_ring import _FakeGroup, _Net

BF16 = np.dtype(ml_dtypes.bfloat16)
WORLDS = [1, 2, 3, 8]
DTYPES = ["float32", "int32", "bfloat16"]
CODECS = ["none", "bf16", "int8"]
OPS = ["sum", "mean", "max", "min"]
SHAPE = (37, 29)  # 1073 elements: ragged segments and int8 blocks


class _JaxGroup(_FakeGroup):
    """The fake group with the star path's send / receive."""

    def _send_to(self, dst, seq, tag, array):
        self._send_obj(dst, seq, tag, np.asarray(array))

    def _recv_from(self, src, seq, tag, timeout=None, op=None):
        return self._recv_obj(src, seq, tag, timeout, op)


def _threads(world, fn, groups):
    outs, errs = [None] * world, []

    def go(r):
        try:
            outs[r] = fn(groups[r], r)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=go, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    return outs


def jax_world(world, fn, name="t"):
    net = _Net()
    try:
        return _threads(world, fn, [_JaxGroup(net, name, world, r)
                                    for r in range(world)])
    finally:
        jring.purge_group(name)


def port_world(world, fn, name="t"):
    fabric = col.LocalFabric(world)
    try:
        return _threads(world, fn, [col.Group(name, world, r, fabric)
                                    for r in range(world)])
    finally:
        ring.purge_group(name)


def payloads(dtype, world, seed, shape=SHAPE):
    """Each rank's (JAX array, port tensor) of the same seeded bits."""
    out = []
    for r in range(world):
        rng = np.random.default_rng(seed * 100 + r)
        if dtype == "int32":
            x = rng.integers(-1000, 1000, shape).astype(np.int32)
            out.append((x, torch.from_numpy(x.copy())))
            continue
        x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
             ).astype(np.float32)
        if dtype == "float32":
            out.append((x, torch.from_numpy(x.copy())))
        else:
            jx = x.astype(BF16)
            out.append((jx, torch.from_numpy(jx.view(np.int16).copy())
                        .view(torch.bfloat16)))
    return out


def bits(x):
    """(dtype name, shape, bytes) of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        data = (x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                if x.numel() else b"")
        return str(x.dtype).removeprefix("torch."), tuple(x.shape), data
    x = np.asarray(x)
    return x.dtype.name, tuple(x.shape), np.ascontiguousarray(x).tobytes()


@pytest.fixture
def jax_stats(monkeypatch):
    """Each JAX rank's OpStats of its last op (JAX keys them by group
    only, and the fake ranks share this process)."""
    seen = {}
    finish = jring._finish

    def keep(g, st):
        seen[g.rank] = st
        finish(g, st)

    monkeypatch.setattr(jring, "_finish", keep)
    return seen


def _stat_fields(st):
    return (st.op, st.transport, st.codec, st.world_size, st.tensor_bytes,
            st.bytes_sent, st.bytes_recv, st.chunks)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_and_reducescatter_equal_jax(world, dtype, codec, op,
                                               jax_stats):
    data = payloads(dtype, world, seed=WORLDS.index(world) * 97
                    + DTYPES.index(dtype) * 13 + CODECS.index(codec) * 3
                    + OPS.index(op))

    def jax_fn(g, r):
        a = jring.ring_allreduce(g, data[r][0], op=op, codec=codec)
        a_st = _stat_fields(jax_stats[r])
        s = jring.ring_reducescatter(g, data[r][0], op=op, codec=codec)
        return a, a_st, s, _stat_fields(jax_stats[r])

    def port_fn(g, r):
        a = ring.ring_allreduce(g, data[r][1], op=op, codec=codec)
        a_st = _stat_fields(ring.last_op_stats(g.name, r))
        s = ring.ring_reducescatter(g, data[r][1], op=op, codec=codec)
        return a, a_st, s, _stat_fields(ring.last_op_stats(g.name, r))

    want = jax_world(world, jax_fn)
    got = port_world(world, port_fn)
    for r in range(world):
        assert bits(got[r][0]) == bits(want[r][0]), f"allreduce rank {r}"
        assert got[r][1] == want[r][1], f"allreduce stats rank {r}"
        assert bits(got[r][2]) == bits(want[r][2]), f"reducescatter rank {r}"
        assert got[r][3] == want[r][3], f"reducescatter stats rank {r}"


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_allgather_equals_jax(world, dtype, codec, jax_stats):
    data = payloads(dtype, world, seed=7 + WORLDS.index(world), shape=(101,))

    def jax_fn(g, r):
        out = jring.ring_allgather(g, data[r][0], codec=codec)
        return out, _stat_fields(jax_stats[r])

    def port_fn(g, r):
        out = ring.ring_allgather(g, data[r][1], codec=codec)
        return out, _stat_fields(ring.last_op_stats(g.name, r))

    want = jax_world(world, jax_fn)
    got = port_world(world, port_fn)
    for r in range(world):
        assert [bits(x) for x in got[r][0]] == [bits(x) for x in want[r][0]]
        assert got[r][1] == want[r][1]


@pytest.mark.parametrize("chunk_bytes", [256, 1000])
@pytest.mark.parametrize("codec", CODECS)
def test_chunk_sizes_equal_jax(codec, chunk_bytes, jax_stats):
    """Many chunks a segment (one ragged); the chunk size changes no bit
    of the f32 sum."""
    data = payloads("float32", 3, seed=300 + chunk_bytes)

    def jax_fn(g, r):
        out = jring.ring_allreduce(g, data[r][0], codec=codec,
                                   chunk_bytes=chunk_bytes)
        return out, _stat_fields(jax_stats[r])

    def port_fn(g, r):
        out = ring.ring_allreduce(g, data[r][1], codec=codec,
                                  chunk_bytes=chunk_bytes)
        return out, _stat_fields(ring.last_op_stats(g.name, r))

    want = jax_world(3, jax_fn)
    got = port_world(3, port_fn)
    one_chunk = port_world(3, lambda g, r: ring.ring_allreduce(
        g, data[r][1], codec=codec))
    for r in range(3):
        assert bits(got[r][0]) == bits(want[r][0])
        assert got[r][1] == want[r][1] and got[r][1][-1] > 4
        if codec == "none":
            assert bits(got[r][0]) == bits(one_chunk[r])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("world", [2, 3])
def test_error_feedback_over_three_calls_equals_jax(world, codec, dtype):
    """Residuals keyed (group, rank, tag, segment, chunk) carry from call
    to call: the 3 calls' results equal JAX's, and differ from 3 calls
    without a tag where the codec leaves a residual."""
    calls = [payloads(dtype, world, seed=500 + i) for i in range(3)]

    def run(mod, side, tag):
        def fn(g, r):
            return [mod.ring_allreduce(g, c[r][side], op="mean", codec=codec,
                                       ef_tag=tag, chunk_bytes=1024)
                    for c in calls]
        return fn

    want = jax_world(world, run(jring, 0, "dcn:0"))
    got = port_world(world, run(ring, 1, "dcn:0"))
    plain = port_world(world, run(ring, 1, None))
    for r in range(world):
        assert [bits(x) for x in got[r]] == [bits(x) for x in want[r]]
    assert bits(got[0][0]) == bits(plain[0][0])  # nothing to fold yet
    if codec == "int8" or dtype == "float32" or world > 2:
        # (a bf16 payload's own segment rounds to bf16 with no residual)
        assert bits(got[0][2]) != bits(plain[0][2])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", [1, 2, 3])
def test_star_equals_jax_star(world, dtype, op, jax_stats):
    data = payloads(dtype, world, seed=900 + OPS.index(op))

    def jax_fn(g, r):
        return jcol._star_allreduce(g, data[r][0], op, 30)

    def port_fn(g, r):
        return col.allreduce(g, data[r][1], op, transport="star", timeout=30)

    want = jax_world(world, jax_fn)
    got = port_world(world, port_fn)
    for r in range(world):
        assert bits(got[r]) == bits(want[r]), f"rank {r}"


def test_star_reducescatter_and_allgather_match_jax():
    data = payloads("float32", 3, seed=950)

    def jax_fn(g, r):
        return (jcol._star_allreduce(g, data[r][0], "sum", 30),)

    def port_fn(g, r):
        return (col.reducescatter(g, data[r][1], transport="star"),
                col.allgather(g, data[r][1], transport="star"))

    want = jax_world(3, jax_fn)
    got = port_world(3, port_fn)
    shards = np.array_split(want[0][0], 3, axis=0)
    for r in range(3):
        assert bits(got[r][0]) == bits(shards[r])
        assert [bits(x) for x in got[r][1]] == [bits(d[1]) for d in data]


def test_unknown_transport_raises():
    g = col.Group("t", 1, 0, col.LocalFabric(1))
    with pytest.raises(ValueError, match="transport"):
        col.allreduce(g, np.zeros(3, np.float32), transport="tree")


def test_a_lost_peer_aborts_the_waiting_ranks_with_names():
    """A LocalFabric check reporting a peer's loss ends every waiting
    rank's op with CollectiveAbortError naming the group, rank and op."""
    lost = threading.Event()

    def check(rank):
        return {"reason": "rank 2 died", "origin": 2} if lost.is_set() else None

    fabric = col.LocalFabric(3, check)
    groups = [col.Group("g", 3, r, fabric) for r in range(3)]
    errs = {}

    def go(r):
        try:
            col.allreduce(groups[r], np.ones(10, np.float32), timeout=30)
        except col.CollectiveAbortError as e:
            errs[r] = e

    threads = [threading.Thread(target=go, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    lost.set()
    for t in threads:
        t.join(10)
    assert sorted(errs) == [0, 1]
    for r, e in errs.items():
        assert (e.group, e.rank, e.origin_rank) == ("g", r, 2)
        assert e.op.startswith("ar:") and "rank 2 died" in str(e)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("codec", CODECS)
def test_allreduce_into_out_equals_jax(codec, dtype):
    """``out`` (the port's in-place form, which the train gang uses):
    the input reduced in place, returned, with JAX's bits; the group's
    f32 scratch buffer is reused from call to call."""
    data = payloads(dtype, 3, seed=700 + CODECS.index(codec))
    op = "sum" if dtype == "int32" else "mean"

    def jax_fn(g, r):
        return [jring.ring_allreduce(g, data[r][0], op=op, codec=codec,
                                     ef_tag="b") for _ in range(2)]

    def port_fn(g, r):
        outs = []
        for _ in range(2):
            buf = data[r][1].clone()
            got = ring.ring_allreduce(g, buf, op=op, codec=codec, ef_tag="b",
                                      out=buf)
            assert got is buf
            outs.append(buf)
        return outs

    want = jax_world(3, jax_fn)
    got = port_world(3, port_fn)
    for r in range(3):
        assert [bits(x) for x in got[r]] == [bits(x) for x in want[r]]


# ---------------------------------------------------------------------------
# the rooted ops and the barrier, against JAX's on the fake group
# ---------------------------------------------------------------------------

_jax_group = threading.local()


@pytest.fixture
def jax_by_thread(monkeypatch):
    """JAX's reduce / broadcast / barrier look their group up by name;
    here each thread's fake rank is its group."""
    monkeypatch.setattr(jcol, "_group", lambda name: _jax_group.g)


def _as_thread_group(fn):
    def run(g, r):
        _jax_group.g = g
        return fn(g, r)
    return run


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,root", [(1, 0), (2, 1), (3, 0), (3, 2)])
def test_reduce_equals_jax(world, root, dtype, op, jax_by_thread):
    data = payloads(dtype, world, seed=1300 + OPS.index(op))
    want = jax_world(world, _as_thread_group(
        lambda g, r: jcol.reduce(data[r][0], root, "t", op)))
    got = port_world(world, lambda g, r: col.reduce(g, data[r][1], root, op))
    for r in range(world):
        assert bits(got[r]) == bits(want[r]), f"rank {r}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,root", [(1, 0), (2, 1), (3, 0), (3, 2)])
def test_broadcast_equals_jax(world, root, dtype, jax_by_thread):
    data = payloads(dtype, world, seed=1400)
    want = jax_world(world, _as_thread_group(
        lambda g, r: jcol.broadcast(data[r][0], root, "t")))
    got = port_world(world, lambda g, r: col.broadcast(g, data[r][1], root))
    for r in range(world):
        assert bits(got[r]) == bits(want[r]) == bits(data[root][0]), f"rank {r}"


@pytest.mark.parametrize("world", [1, 2, 3])
def test_barrier_equals_jax(world, jax_by_thread):
    """Every rank leaves the barrier after the last one entered it, having
    run JAX's op (its seq and wire bytes)."""
    def ranks(barrier, groups_stats):
        entered, left = [None] * world, [None] * world

        def fn(g, r):
            if r == world - 1:
                time.sleep(0.3)
            entered[r] = time.monotonic()
            assert barrier(g) is None
            left[r] = time.monotonic()
            return g.seq, groups_stats(g)
        return fn, entered, left

    jfn, jin, jout = ranks(lambda g: jcol.barrier("t"),
                           lambda g: None)
    want = jax_world(world, _as_thread_group(jfn))
    pfn, pin, pout = ranks(col.barrier, lambda g: ring.last_op_stats(
        g.name, g.rank).bytes_sent)
    got = port_world(world, pfn)
    # one op of the group's sequence (none at world 1: no frame moves)
    assert [w[0] for w in want] == [g[0] for g in got] == \
        [int(world > 1)] * world
    for entered, left in ((jin, jout), (pin, pout)):
        assert min(left) >= max(entered)
    # an allreduce of one f64 zero: 2·(N−1)/N of 8 bytes a rank, ragged
    assert sum(g[1] for g in got) == (0 if world == 1 else 2 * 8 * (world - 1))
