"""Cross-worker gradient synchronization over the gang's collective.

The port's counterpart of ray_tpu/train/dcn.py. ``dcn_allreduce_grads``
is the call a train loop makes between backward and the optimizer
update: it flattens the gradient tree (JAX's leaf order) into
fixed-byte, dtype-homogeneous buckets (``_fill_buckets``, a copy of
JAX's, so the buckets hold the same leaves) and reduces each bucket
across the gang. The reduction is the calling worker's ``allreduce``
(``train/worker_group.py``), reached through the train session: the
in-process gang runs the port's ring (``ray_tpu_torch/collective/``,
JAX's default transport) with ``codec`` none, bf16 or int8 and error
feedback by bucket; a runtime hosting the port on ray_tpu's actors
passes the codec to its ring. Each bucket is staged
through one host buffer that the worker keeps from call to call (pinned
when the gradients live on the card), instead of a host copy of every
leaf, and reduced in it (the allreduce's ``out``); the whole sync is added to the step's ``collective`` segment.

``init_cross_slice_group`` and ``reform_cross_slice_group`` are runtime
calls in the port: the gang rendezvouses its group when the backend
starts (``BackendExecutor``), and reforms it under a new epoch after a
heal. Inside a loop they return the session's group.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.collective.compression import BUCKET_BYTES
from ray_tpu_torch.train import session as _sess
from ray_tpu_torch.train.checkpoint import _flatten

__all__ = ["dcn_allreduce_grads", "init_cross_slice_group",
           "reform_cross_slice_group"]


def init_cross_slice_group(group_name: str | None = None, **_) -> str:
    """The gang's collective group, which the runtime rendezvoused before
    the loop started (the session's name for it)."""
    name = _sess.get_collective_group()
    if name is None:
        raise RuntimeError("this worker has no collective group: the "
                           "trainer's backend must be 'dcn'")
    if group_name not in (None, name):
        raise ValueError(f"the gang's group is {name!r}, not {group_name!r}")
    return name


def reform_cross_slice_group(group_name: str | None = None, **_) -> str:
    """The group after a reform: the executor re-forms it under a new
    epoch before it restarts the loops (``BackendExecutor.heal_inplace``),
    so a loop only looks up its name."""
    return init_cross_slice_group(group_name)


def _fill_buckets(leaves: list, bucket_bytes: int):
    """Pack consecutive same-dtype leaves into <= bucket_bytes buckets.

    Yields ``(bucket_id, dtype, members)`` with members as
    ``(leaf_index, shape, nelems)``; consecutive-leaf packing keeps
    bucket membership stable across steps (same tree -> same buckets).
    """
    bucket: list[tuple[int, tuple, int]] = []
    cur_dtype = None
    cur_bytes = 0
    bucket_id = 0
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size() \
            if isinstance(leaf, torch.Tensor) else leaf.nbytes
        if bucket and (leaf.dtype != cur_dtype
                       or cur_bytes + nbytes > bucket_bytes):
            yield bucket_id, cur_dtype, bucket
            bucket_id += 1
            bucket, cur_bytes = [], 0
        cur_dtype = leaf.dtype
        bucket.append((i, tuple(leaf.shape), int(np.prod(leaf.shape,
                                                         dtype=np.int64))))
        cur_bytes += nbytes
    if bucket:
        yield bucket_id, cur_dtype, bucket


def _staging(sess, key, n: int, dtype, pin: bool) -> torch.Tensor:
    """The worker's host buffer for a bucket, kept across calls."""
    bufs = sess.worker.state.setdefault("dcn_staging", {}) \
        if sess.worker is not None else {}
    buf = bufs.get(key)
    if buf is None or buf.numel() != n or buf.dtype != dtype:
        buf = bufs[key] = torch.empty(n, dtype=dtype, pin_memory=pin)
    return buf


def dcn_allreduce_grads(grads: Any, group_name: str = "dcn", *,
                        op: str = "mean", codec=None,
                        bucket_bytes: int | None = None,
                        transport: str | None = None,
                        timeout: float | None = None) -> Any:
    """Reduce (default ``mean``) a gradient tree across the gang.

    Returns a tree of the same structure: tensors on their own device
    (each bucket reduced on the host), numpy leaves as numpy. Leaves are
    synced in fixed-byte buckets in leaf order; the bucket id tags each
    bucket (``dcn:{id}``) for the runtime's error feedback."""
    leaves, structure = _flatten(grads)
    if not leaves:
        return grads
    sess = _sess._get_session()
    allreduce = sess.worker.allreduce
    t_coll = time.monotonic()
    as_numpy = [isinstance(x, np.ndarray) for x in leaves]
    tensors = [torch.from_numpy(np.ascontiguousarray(x)) if a else x.detach()
               for x, a in zip(leaves, as_numpy)]
    bucket_bytes = int(bucket_bytes or BUCKET_BYTES)
    out: list = [None] * len(tensors)
    for bucket_id, dtype, members in _fill_buckets(tensors, bucket_bytes):
        device = tensors[members[0][0]].device
        pin = device.type == "cuda"
        n_total = sum(n for _, _, n in members)
        buf = _staging(sess, (group_name, bucket_id), n_total, dtype, pin)
        pos = 0
        for i, _, n in members:
            buf[pos:pos + n].copy_(tensors[i].reshape(-1), non_blocking=pin)
            pos += n
        if pin:
            torch.cuda.current_stream(device).synchronize()
        # reduced into the staging buffer (a mean of integers, float as
        # JAX's, comes back in a tensor of its own)
        synced = allreduce(buf, group_name, op, codec=codec,
                           transport=transport, timeout=timeout,
                           ef_tag=f"dcn:{bucket_id}", out=buf)
        pos = 0
        for i, shape, n in members:
            piece = synced[pos:pos + n].view(shape)
            out[i] = (piece.numpy().copy() if as_numpy[i]
                      else piece.to(device, non_blocking=pin, copy=True))
            pos += n
    # the whole bucketed sync is the step's collective wait
    _sess._add_step_time("collective", time.monotonic() - t_coll)
    return structure.unflatten(out)
