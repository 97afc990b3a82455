"""Collectives over one axis of a device mesh.

Mirrors ray_tpu/collective/mesh_ops.py. JAX's helpers take a global
array, run the lax collective inside ``shard_map`` and return a global
array; here every rank calls the helper with what its device holds in
JAX (its replica of ``x``, or its shard of it along the named dim) and
gets back what JAX's shard_map body returns on that device. The group is
the ranks that differ only in their coordinate on ``axis``
(``mesh.get_group(axis)``), ordered by that coordinate.

``mesh_ppermute`` and ``mesh_all_to_all`` are differentiable (the
backward is the reverse shift, or the inverse exchange): ring and
Ulysses attention differentiate through them. ``wrap=False`` runs the
bare collective, outside autograd; the other four are not
differentiated and take ``wrap`` for JAX's call shape only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


def _group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis)


def mesh_allreduce(x: torch.Tensor, mesh: DeviceMesh, axis: str, op: str = "sum",
                   *, wrap: bool = True) -> torch.Tensor:
    """Reduce each rank's replica over the axis (``op``: sum, max, min or
    mean, mean being the sum over the axis size, as ``jax.lax.pmean``)."""
    if op not in _OPS:
        raise ValueError(f"op {op!r} not in {sorted(_OPS)}")
    group, n, _ = _group(mesh, axis)
    out = x.clone()
    dist.all_reduce(out, _OPS[op], group=group)
    return out / n if op == "mean" else out


def mesh_allgather(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                   tiled_axis: int = 0, wrap: bool = True) -> torch.Tensor:
    """The axis members' shards concatenated along ``tiled_axis``, in
    member order."""
    group, n, _ = _group(mesh, axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=tiled_axis)


def mesh_reducescatter(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                       scatter_axis: int = 0, wrap: bool = True) -> torch.Tensor:
    """The sum of the members' replicas, of which each member keeps its
    block along ``scatter_axis``."""
    group, n, _ = _group(mesh, axis)
    src = x.movedim(scatter_axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} does not "
                         f"split over {n} members")
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, scatter_axis)


def mesh_broadcast(x: torch.Tensor, mesh: DeviceMesh, axis: str, root: int = 0,
                   *, wrap: bool = True) -> torch.Tensor:
    """Member ``root``'s replica, on every member of the axis."""
    group, _, _ = _group(mesh, axis)
    out = x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, root), group=group)
    return out


def _shift(x: torch.Tensor, group, n: int, me: int, shift: int) -> torch.Tensor:
    """Send x to member (me + shift) % n; return what member
    (me - shift) % n sent."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, shift):
        ctx.args = (group, n, me, shift)
        return _shift(x, group, n, me, shift)

    @staticmethod
    def backward(ctx, grad):
        group, n, me, shift = ctx.args
        return _shift(grad, group, n, me, -shift), None, None, None, None


def mesh_ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int = 1,
                  *, shard_axis: int = 0, wrap: bool = True) -> torch.Tensor:
    """Each member's shard moves to its ring neighbour ``shift`` hops on:
    member i returns member (i - shift) mod n's. ``shard_axis`` is the
    dim JAX shards over the axis; a rank passes its shard whole, so it
    changes nothing here."""
    group, n, me = _group(mesh, axis)
    if n == 1 or shift % n == 0:
        return x
    if not wrap:
        return _shift(x, group, n, me, shift)
    return _Permute.apply(x, group, n, me, shift)


def _exchange(x: torch.Tensor, group, n: int, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: block j of x along split_axis goes to member j;
    the blocks received are concatenated along concat_axis in member
    order."""
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} members")
    src = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _exchange(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, n, split_axis, concat_axis = ctx.args
        return _exchange(grad, group, n, concat_axis, split_axis), None, None, \
            None, None


def mesh_all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                    split_axis: int, concat_axis: int,
                    wrap: bool = True) -> torch.Tensor:
    """All-to-all over the axis (the Ulysses head/sequence exchange): x
    split into n blocks along ``split_axis``, block j to member j, the
    received blocks concatenated along ``concat_axis``."""
    group, n, _ = _group(mesh, axis)
    if not wrap:
        return _exchange(x, group, n, split_axis, concat_axis)
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)
