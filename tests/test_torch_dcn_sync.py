"""The port's bucketed gradient sync against the JAX package's.

``dcn_allreduce_grads`` packs the gradient tree into buckets with a copy
of JAX's ``_fill_buckets``: the same leaves land in the same buckets. Its
reduction runs on the in-process gang (``train/worker_group.py``), each
worker a thread with a train session; the mean of world 1, 2 and 3 equals
the numpy mean over the workers' trees (tests/test_dcn_sync.py's
reference, through ``jax.tree_util``) within 1e-6 relative in f32, and
every worker gets the same bits. The gang's reduction is the port's ring
(``ray_tpu_torch/collective/``): at world 3 its mean of f32 and bf16
trees equals JAX's ``dcn_allreduce_grads`` over JAX's ring on the same
buckets bit for bit (JAX's ranks as threads of tests/test_collective_ring.py's
fake group), and so do the bf16 and int8 codecs with error feedback over
2 calls at world 2 and 3. A worker killed in the middle of a ring ends
the survivors' sync with ``CollectiveAbortError``.
"""

import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.collective import ring as jring
from ray_tpu.train import dcn as jdcn
from ray_tpu_torch.collective.collective import CollectiveAbortError
from ray_tpu_torch.train import dcn, session
from ray_tpu_torch.train.worker_group import (InProcessWorkerGroup,
                                              WorkerDiedError)

from test_collective_ring import _FakeGroup, _Net


def _slice_grads(rank: int) -> dict:
    """tests/test_dcn_sync.py's per-slice gradient tree."""
    rng = np.random.default_rng(100 + rank)
    return {"dense": {"w": rng.standard_normal((32, 16)).astype(np.float32),
                      "b": rng.standard_normal(16).astype(np.float32)},
            "emb": rng.standard_normal((64, 8)).astype(np.float32)}


def _mixed_leaves():
    rs = np.random.RandomState(4)
    shapes = [(32, 16), (16,), (64, 8), (3,), (100, 50), (7, 7), (1,), (40, 40)]
    dtypes = [np.float32, np.float32, np.float16, np.float16, np.float32,
              np.int32, np.float32, np.float32]
    return [rs.randn(*s).astype(d) for s, d in zip(shapes, dtypes)]


def _members(buckets):
    return [(b, str(np.dtype(d) if not isinstance(d, torch.dtype) else d),
             [(i, tuple(shape), n) for i, shape, n in m]) for b, d, m in buckets]


@pytest.mark.parametrize("bucket_bytes", [64, 1024, 4096, 20000, 4 * 2**20])
def test_bucket_membership_equals_jax(bucket_bytes):
    leaves = _mixed_leaves()
    want = _members(jdcn._fill_buckets(leaves, bucket_bytes))
    got = _members(dcn._fill_buckets(leaves, bucket_bytes))
    assert got == want
    # torch leaves of the same shapes and sizes take the same buckets
    tl = [torch.from_numpy(x) for x in leaves]
    got_t = [(b, [(i, s, n) for i, s, n in m])
             for b, _, m in _members(dcn._fill_buckets(tl, bucket_bytes))]
    assert got_t == [(b, m) for b, _, m in want]


def _on_gang(n, fn, *args):
    """fn(worker, *args) on each of n in-process workers, each with a train
    session on the gang's collective group; their results in rank order."""
    wg = InProcessWorkerGroup(n)
    group = wg.init_collective()

    def run(w, *a):
        session._bind(session._init_session(
            world_rank=w.coll_rank, world_size=n, collective_group=group,
            worker=w))
        try:
            return fn(w, group, *a)
        finally:
            session._bind(None)

    try:
        return wg.execute(run, *args, timeout=60)
    finally:
        wg.shutdown()


def _sync(w, group, codec, bucket_bytes, as_torch):
    grads = _slice_grads(w.coll_rank)
    if as_torch:
        grads = jax.tree_util.tree_map(torch.from_numpy, grads)
    return dcn.dcn_allreduce_grads(grads, group, codec=codec,
                                   bucket_bytes=bucket_bytes)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_mean_equals_numpy_mean(world, as_torch):
    outs = _on_gang(world, _sync, None, 1024, as_torch)
    trees = [_slice_grads(r) for r in range(world)]
    ref = jax.tree_util.tree_map(lambda *xs: np.mean(np.stack(xs), axis=0),
                                 *trees)
    flat_r = jax.tree_util.tree_leaves(ref)
    for synced in outs:
        flat_s = jax.tree_util.tree_leaves(synced)
        assert len(flat_s) == len(flat_r)
        for s, r in zip(flat_s, flat_r):
            assert isinstance(s, torch.Tensor) == as_torch
            s = s.numpy() if as_torch else s
            assert s.shape == r.shape and s.dtype == r.dtype
            np.testing.assert_allclose(s, r, rtol=1e-6, atol=1e-7)
    for other in outs[1:]:  # every worker got the same bits
        for a, b in zip(jax.tree_util.tree_leaves(outs[0]),
                        jax.tree_util.tree_leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_mean_rounds_once():
    def sync(w, group):
        g = torch.Generator().manual_seed(w.coll_rank)
        x = torch.randn(1000, generator=g).to(torch.bfloat16)
        return x, dcn.dcn_allreduce_grads({"x": x}, group)["x"]

    outs = _on_gang(2, sync)
    want = ((outs[0][0].float() + outs[1][0].float()) / 2).to(torch.bfloat16)
    for _, got in outs:
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_sum_op_and_staging_reuse():
    def sync(w, group):
        a = dcn.dcn_allreduce_grads({"g": np.full(5, w.coll_rank + 1.0,
                                                  np.float32)}, group, op="sum")
        bufs = dict(w.state["dcn_staging"])
        b = dcn.dcn_allreduce_grads({"g": np.ones(5, np.float32)}, group,
                                    op="sum")
        same = all(w.state["dcn_staging"][k] is v for k, v in bufs.items())
        return a["g"], b["g"], same

    for a, b, same in _on_gang(3, sync):
        np.testing.assert_array_equal(a, np.full(5, 6.0, np.float32))
        np.testing.assert_array_equal(b, np.full(5, 3.0, np.float32))
        assert same


@pytest.mark.parametrize("transport", ["ring", "star"])
@pytest.mark.parametrize("dtype,op", [(torch.float32, "sum"),
                                      (torch.bfloat16, "mean"),
                                      (torch.int32, "mean")],
                         ids=["f32-sum", "bf16-mean", "i32-mean"])
def test_gang_allreduce_writes_its_input_only_as_out(transport, dtype, op):
    """A worker's allreduce leaves its input as it was and returns a new
    result, unless it is handed ``out``: then ``out`` holds the result
    and is returned (the mean of integers, float64 as numpy's, comes back
    in a tensor of its own, and ``out`` is not written)."""
    def reduce(w, group):
        x = (torch.arange(6, dtype=torch.float32) * (w.coll_rank + 1)).to(dtype)
        kept = x.clone()
        new = w.allreduce(x, group, op, transport=transport)
        untouched = torch.equal(x, kept)
        into = torch.zeros_like(x)
        got = w.allreduce(x, group, op, transport=transport, out=into)
        return untouched, new, got, into

    for untouched, new, got, into in _on_gang(3, reduce):
        assert untouched
        assert torch.equal(got, new)
        if new.dtype == dtype:
            assert got is into
        else:
            assert new.dtype == torch.float64 and not into.any()


def _tree(rank: int, step: int, bf16: bool):
    """A worker's gradient tree: _slice_grads at step 0, other seeds
    after; bf16 as JAX's ml_dtypes arrays (the port takes the same bits
    as torch.bfloat16)."""
    tree = _slice_grads(rank + 10 * step)
    if bf16:
        tree = jax.tree_util.tree_map(
            lambda x: x.astype(ml_dtypes.bfloat16), tree)
    return tree


def _as_port(tree):
    def one(x):
        if x.dtype == np.dtype(ml_dtypes.bfloat16):
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return jax.tree_util.tree_map(one, tree)


def _jax_ring_sync(world, trees_by_step, codec, bucket_bytes):
    """JAX's dcn_allreduce_grads on each of ``world`` threaded ranks of
    the fake group, its allreduce routed to JAX's ring there; a list of
    each step's synced tree, by rank."""
    net, local = _Net(), threading.local()

    def ring_allreduce(tensor, group_name, op, *, codec, transport, timeout,
                       ef_tag):
        return jring.ring_allreduce(local.g, np.asarray(tensor), op=op,
                                    codec=codec, timeout=timeout,
                                    ef_tag=ef_tag)

    outs = [None] * world

    def go(r):
        local.g = _FakeGroup(net, "dcn", world, r)
        outs[r] = [jdcn.dcn_allreduce_grads(trees[r], "dcn", codec=codec,
                                            bucket_bytes=bucket_bytes)
                   for trees in trees_by_step]

    orig = jdcn._col.allreduce
    jdcn._col.allreduce = ring_allreduce
    try:
        threads = [threading.Thread(target=go, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        jdcn._col.allreduce = orig
        jring.purge_group("dcn")
    return outs


def _leaf_bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.itemsize == 2 else x).tobytes()


def _assert_bits_equal(got_trees, want_trees):
    for got, want in zip(got_trees, want_trees):
        g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert tuple(a.shape) == tuple(b.shape)
            assert _leaf_bits(a) == _leaf_bits(b)


def _gang_sync(world, trees_by_step, codec, bucket_bytes):
    def sync(w, group):
        return [dcn.dcn_allreduce_grads(_as_port(trees[w.coll_rank]), group,
                                        codec=codec, bucket_bytes=bucket_bytes)
                for trees in trees_by_step]
    return _on_gang(world, sync)


# elements of the 1,040 where a rank-order f32 sum rounded once (the
# gang's rule before it ran the ring) is off JAX's ring at world 3
OLD_RULE_OFF = {"float32": 201, "bfloat16": 373}


def _rank_order_mean(trees):
    def one(*xs):
        acc = xs[0].to(torch.float32, copy=True)
        for x in xs[1:]:
            acc += x
        return acc.div_(len(xs)).to(xs[0].dtype)
    return jax.tree_util.tree_map(one, *[_as_port(t) for t in trees])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gang_sync_matches_jax_ring(dtype):
    """World 3: the gang's mean over the ring equals JAX's bit for bit;
    a rank-order f32 sum rounded once is off it in OLD_RULE_OFF of the
    1,040 elements."""
    steps = [[_tree(r, 0, dtype == "bfloat16") for r in range(3)]]
    want = _jax_ring_sync(3, steps, None, 1024)
    got = _gang_sync(3, steps, None, 1024)
    for r in range(3):
        _assert_bits_equal(got[r], want[r])
    width = 2 if dtype == "bfloat16" else 4

    def elements(x):
        return np.frombuffer(_leaf_bits(x), np.uint8).reshape(-1, width)

    old = jax.tree_util.tree_leaves(_rank_order_mean(steps[0]))
    off = sum(int((elements(a) != elements(b)).any(axis=1).sum())
              for a, b in zip(old, jax.tree_util.tree_leaves(want[0][0])))
    assert off == OLD_RULE_OFF[dtype]


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_gang_codec_matches_jax_ring(codec):
    """A codec on the gang, with error feedback by bucket (``dcn:{id}``)
    over 2 calls, at world 2 and 3: JAX's bits."""
    for world in (2, 3):
        steps = [[_tree(r, s, False) for r in range(world)] for s in range(2)]
        want = _jax_ring_sync(world, steps, codec, 1024)
        got = _gang_sync(world, steps, codec, 1024)
        for r in range(world):
            _assert_bits_equal(got[r], want[r])


def test_a_kill_in_the_middle_of_a_ring_aborts_the_survivors():
    """World 3: workers 0 and 2 enter the ring, worker 1 is killed while
    they wait on it; both raise CollectiveAbortError naming the group and
    their rank, well before the 120 s timeout."""
    wg = InProcessWorkerGroup(3)
    group = wg.init_collective()
    entered = threading.Barrier(3, timeout=30)

    def run(w):
        session._bind(session._init_session(
            world_rank=w.coll_rank, world_size=3, collective_group=group,
            worker=w))
        try:
            if w.coll_rank == 1:
                entered.wait()
                while True:  # ends at its kill (WorkerKilled)
                    w.check()
                    time.sleep(0.01)
            entered.wait()
            try:
                dcn.dcn_allreduce_grads(_slice_grads(w.coll_rank), group)
            except CollectiveAbortError as e:
                return e
            return None
        finally:
            session._bind(None)

    try:
        refs = [wg.submit(w, run) for w in wg.workers]
        time.sleep(0.5)  # ranks 0 and 2 are waiting inside the ring
        t0 = time.monotonic()
        wg.kill(wg.workers[1])
        errs = [wg.get(refs[r], timeout=30) for r in (0, 2)]
        assert time.monotonic() - t0 < 10
        with pytest.raises(WorkerDiedError):
            wg.get(refs[1], timeout=30)
    finally:
        wg.shutdown()
    for r, e in zip((0, 2), errs):
        assert isinstance(e, CollectiveAbortError)
        assert (e.group, e.rank) == (group, r)
        assert e.op and "aborted" in str(e)
