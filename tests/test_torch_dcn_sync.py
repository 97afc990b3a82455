"""The port's bucketed gradient sync against the JAX package's.

``dcn_allreduce_grads`` packs the gradient tree into buckets with a copy
of JAX's ``_fill_buckets``: the same leaves land in the same buckets. Its
reduction runs on the in-process gang (``train/worker_group.py``), each
worker a thread with a train session; the mean of world 1, 2 and 3 equals
the numpy mean over the workers' trees (tests/test_dcn_sync.py's
reference, through ``jax.tree_util``) within 1e-6 relative in f32, and
every worker gets the same bits. The in-process gang has no wire, so a
codec is refused.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.train import dcn as jdcn
from ray_tpu_torch.train import dcn, session
from ray_tpu_torch.train.worker_group import InProcessWorkerGroup


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


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_in_process_gang_refuses_a_codec(codec):
    def sync(w, group):
        with pytest.raises(ValueError, match="codec"):
            _sync(w, group, codec, 1024, False)
        return True

    assert _on_gang(1, sync) == [True]
