"""Logical-axis sharding rules on DTensor.

Mirrors ray_tpu/parallel/sharding.py: models name every dimension of a
parameter or activation logically ("embed", "heads", "batch", ...), and
one rule table maps the names onto mesh axes. A spec here is a tuple with
one entry per tensor dimension (None, a mesh axis, or a tuple of mesh
axes), the entries JAX's ``PartitionSpec`` holds. DTensor wants one
placement per mesh dimension instead, which ``spec_to_placements``
derives: tensor dimension d sharded over axes (a, b) puts ``Shard(d)`` on
mesh dims a and b, a split major to minor in mesh order, as JAX splits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.mesh import (active_axes, active_mesh,
                                         current_active_mesh, current_mesh)

# A rule maps a logical axis name -> mesh axis (str), tuple of mesh axes, or
# None (replicated). First matching rule wins.
LogicalRules = tuple[tuple[str, object], ...]

# fsdp shards params along their "embed" dim (ZeRO-3), tp shards
# heads/mlp/vocab (Megatron layout), sp shards the activation sequence
# axis, dp+fsdp share the batch, ep the experts.
DEFAULT_RULES: LogicalRules = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("layers", "pp"),
    ("expert", "ep"),
    ("norm", None),
)


class NamedSharding(NamedTuple):
    """Where a tensor lives: a mesh and one placement per mesh dim."""
    mesh: DeviceMesh
    placements: tuple[Placement, ...]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of mesh axis ``axis`` (1 if the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def logical_to_mesh_spec(
    logical_axes: tuple[str | None, ...],
    rules: LogicalRules = DEFAULT_RULES,
    mesh: DeviceMesh | None = None,
) -> tuple:
    """Resolve logical axis names into spec entries, as JAX's
    ``PartitionSpec``: if ``mesh`` is given, mesh axes of size 1 are
    dropped; a mesh axis is used at most once across the spec (a later
    use falls back to replication); trailing Nones are trimmed."""
    table = dict()
    for name, target in rules:
        table.setdefault(name, target)
    used: set[str] = set()
    out = []
    for ax in logical_axes:
        target = table.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        if mesh is not None:
            axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_to_placements(spec: tuple, mesh: DeviceMesh) -> tuple[Placement, ...]:
    """One placement per dim of ``active_mesh(mesh)``: ``Shard(d)`` on each
    mesh axis that spec entry d names, ``Replicate()`` elsewhere. Axes of
    size 1 shard nothing."""
    names = mesh.mesh_dim_names
    active = active_axes(mesh)
    placements: list[Placement] = [Replicate()] * len(active)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            if axis not in names:
                raise ValueError(f"mesh has no axis {axis!r} ({names})")
            if mesh.size(names.index(axis)) > 1:
                placements[active.index(axis)] = Shard(dim)
    return tuple(placements)


def logical_to_placements(logical_axes, mesh: DeviceMesh,
                          rules: LogicalRules = DEFAULT_RULES):
    """``spec_to_placements`` of ``logical_to_mesh_spec``."""
    return spec_to_placements(logical_to_mesh_spec(logical_axes, rules, mesh),
                              mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def logical_tree_to_shardings(logical_tree, mesh: DeviceMesh,
                              rules: LogicalRules = DEFAULT_RULES):
    """Map a tree (nested dicts) of logical-axis tuples to a tree of
    ``NamedSharding`` on ``active_mesh(mesh)``."""
    active = active_mesh(mesh)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if not _is_axes(node):
            raise TypeError(f"not a tuple of logical axes: {node!r}")
        return NamedSharding(active, logical_to_placements(node, mesh, rules))
    return walk(logical_tree)


def shard_constraint(x, logical_axes, rules: LogicalRules = DEFAULT_RULES):
    """Redistribute DTensor ``x`` to the placements that ``logical_axes``
    resolve to on the ambient mesh (``use_mesh``). The identity on a plain
    tensor or outside a mesh, as JAX's is outside one."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = logical_to_placements(logical_axes, mesh, rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(current_active_mesh(), placements)


def local_slices(shape, mesh: DeviceMesh, placements) -> tuple[slice, ...]:
    """The block of a tensor of global ``shape`` that this rank holds under
    ``placements``: per dimension, the mesh dims that shard it split it in
    mesh order, major to minor, into equal parts (as JAX and DTensor do;
    an uneven split raises)."""
    start, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            n, d = mesh.size(mdim), p.dim % len(shape)
            if size[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"evenly over mesh dim {mdim} of size {n}")
            size[d] //= n
            start[d] += coord[mdim] * size[d]
        elif not isinstance(p, Replicate):
            raise ValueError(f"no local block for placement {p}")
    return tuple(slice(s, s + n) for s, n in zip(start, size))


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A DTensor from the whole tensor ``x``, which every rank holds alike
    (``distribute_tensor`` with ``src_data_rank=None``: no communication).
    The local block is copied, so ``x`` can be freed at once."""
    local = x[local_slices(x.shape, *sharding)].clone()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())


def to_mesh(x: torch.Tensor, logical_axes, rules: LogicalRules = DEFAULT_RULES):
    """Put ``x`` on the ambient mesh by ``logical_axes``: a plain tensor,
    which every rank holds whole, is ``distribute``d; a DTensor is
    ``shard_constraint``ed. The identity outside a mesh."""
    mesh = current_mesh()
    if mesh is None or isinstance(x, DTensor):
        return shard_constraint(x, logical_axes, rules)
    return distribute(x, NamedSharding(
        current_active_mesh(), logical_to_placements(logical_axes, mesh, rules)))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and a weight w [K, N].

    On DTensors each rank multiplies its local blocks (``local_map``), in
    the layout GSPMD picks for these rules; per mesh dim: a weight split
    on K meets x split on K (row parallel: the output is a pending sum)
    or is gathered (fsdp: x is split on its rows there); a weight split
    on N gives an output split on N (column parallel) when x is whole on
    that dim, else it is gathered; x split on K meets a whole weight's
    local K block. DTensor's own matmul folds x's leading dims into one,
    and a fold of batch and sequence split over two mesh dims sends its
    redistribute planner into a search that took ~200 s a forward of the
    tiny test model on torch 2.13."""
    if not isinstance(x, DTensor):
        return x @ w
    k_dim = x.ndim - 1
    x_in, w_in, out, dx, dw = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Shard) and px.dim == k_dim:
            if isinstance(pw, Shard) and pw.dim == 1:
                px = Replicate()  # gather x's K; the output splits on N
            else:
                pw = Shard(0)  # a whole weight's block is a local slice
        elif not isinstance(px, Shard):
            px = Replicate()
        if isinstance(px, Shard) and px.dim != k_dim and isinstance(pw, Shard):
            pw = Replicate()  # gather the weight where x splits its rows
        if not isinstance(pw, Shard):
            pw = Replicate()
        x_in.append(px)
        w_in.append(pw)
        if isinstance(px, Shard) and px.dim == k_dim:  # both split on K
            out.append(Partial())
            dx.append(px)
            dw.append(pw)
        elif pw == Shard(1):
            out.append(Shard(k_dim))
            dx.append(Partial())
            dw.append(pw)
        else:
            out.append(px)
            dx.append(px)
            dw.append(Partial() if isinstance(px, Shard) else pw)
    run = local_map(torch.matmul, out_placements=(tuple(out),),
                    in_placements=(tuple(x_in), tuple(w_in)),
                    in_grad_placements=(tuple(dx), tuple(dw)),
                    device_mesh=x.device_mesh, redistribute_inputs=True)
    return run(x, w)
