"""GPipe pipeline parallelism over the ``pp`` mesh axis.

Mirrors ray_tpu/parallel/pipeline.py: the layer stack is sharded over pp
(one contiguous block of layers per stage), microbatches stream through
the stages, and the only cross-stage communication is one ``ppermute`` of
one microbatch's activations per tick. Plain GPipe: with S stages and M
microbatches the schedule runs M + S - 1 ticks; at tick t stage 0 takes
microbatch t, stage s works on microbatch t - s, and the last stage
finishes microbatch t - (S - 1). Every other mesh axis stays sharded by
the rules inside a stage, as JAX's partial-manual ``shard_map`` keeps
them automatic.

How the port builds the region manual over pp:

- Each stage takes its block of the layer stack, the local block of the
  ``Shard(0)``-over-pp leaf, rewrapped as a DTensor on the submesh of
  the other active axes (plain tensors when pp is the only one), and runs
  its layers under ``use_mesh`` of that submesh, so that the model's
  ``shard_constraint`` and ``to_mesh`` calls place on the weights' mesh.
- The activation comes in replicated over pp. Only stage 0 reads it, so
  its gradient is summed over pp; the output is the last stage's,
  broadcast over pp, and since every pp rank computes the same loss from
  it, its gradient passes back unchanged (JAX's ``psum`` and its
  transpose).
- A rank's autograd graph cannot see that the next stage used its
  activations, so the schedule is one ``torch.autograd.Function`` whose
  backward runs the ticks in reverse: each tick shifts the activation
  gradients one stage back (the transpose of the forward's shift) and
  differentiates the stage's block for that tick. Every rank makes the
  same shifts in the same order.
- Bubble ticks (stage s before microbatch 0 reaches it, or after the
  last one left) skip the compute and still make the tick's shift, so a
  stage runs its layers M times a step where JAX computes on all
  M + S - 1 ticks and masks the bubbles out: the same values, fewer
  launches.
- Rows never interact inside a layer, so each rank splits its own rows
  of the batch (the batch may be split over dp and fsdp) into the
  microbatches: the values are JAX's, which splits the global batch.
  Where a rank's rows do not split into M blocks, they split into
  gcd(rows, M): the values stay the same and only the bubble grows.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.collective.mesh_ops import mesh_ppermute
from ray_tpu_torch.parallel.mesh import (active_axes, active_mesh,
                                         current_mesh, use_mesh)
from ray_tpu_torch.parallel.sharding import axis_size
from ray_tpu_torch.utils.trees import tree_leaves, tree_unflatten


def pipeline_stages(mesh=None, axis: str = "pp") -> int:
    """Size of the pipeline axis in ``mesh`` (or the ambient mesh; 1
    outside one)."""
    if mesh is None:
        mesh = current_mesh()
    return 1 if mesh is None else axis_size(mesh, axis)


def _layers(stacked_params) -> list:
    """Per-layer trees of a stacked [L, ...] tree, one unbind per leaf."""
    leaves = tree_leaves(stacked_params)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(stacked_params, [p[i] for p in per_leaf])
            for i in range(leaves[0].shape[0])]


def _run_layers(layer_fn, stacked_params, h):
    for p in _layers(stacked_params):
        h = layer_fn(h, p)
    return h


def pipeline_apply(
    layer_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    stacked_params,
    h: torch.Tensor,
    *,
    num_microbatches: int,
    axis: str = "pp",
    mesh=None,
):
    """Run a stacked layer tree over ``h`` as an S-stage GPipe pipeline.

    Args:
      layer_fn: ``(h, layer_params) -> h`` applying ONE layer (wrapped in
        activation checkpointing by the caller if remat is wanted).
      stacked_params: tree (nested dicts) whose leaves have a leading
        ``[L, ...]`` layers axis: DTensors on the mesh (resharded to
        ``Shard(0)`` over ``axis`` if they are not), or plain tensors that
        every rank holds whole. L must be divisible by the stage count.
      h: ``[B, ...]`` activations, a DTensor replicated over ``axis`` (the
        other axes may shard it), or a plain tensor every rank holds.
      num_microbatches: M; B must be divisible by M.

    Returns ``[B, ...]`` activations, replicated over ``axis``, placed as
    ``h`` is. On a mesh without ``axis`` (or with it of size 1), or off a
    mesh, this is the plain loop over the layers.
    """
    if mesh is None:
        mesh = current_mesh()
    s_count = 1 if mesh is None else axis_size(mesh, axis)
    if s_count == 1:
        return _run_layers(layer_fn, stacked_params, h)

    leaves = tree_leaves(stacked_params)
    n_layers = leaves[0].shape[0]
    if n_layers % s_count:
        raise ValueError(f"n_layers={n_layers} not divisible by pp={s_count}")
    batch = h.shape[0]
    m = num_microbatches
    if batch % m:
        raise ValueError(f"batch={batch} not divisible by microbatches={m}")

    axes = active_axes(mesh)
    amesh = active_mesh(mesh)
    pp_dim = axes.index(axis)
    inner_axes = tuple(a for a in axes if a != axis)
    inner = mesh[inner_axes] if inner_axes else None

    def without_pp(placements):
        return tuple(p for i, p in enumerate(placements) if i != pp_dim)

    # this stage's block of every leaf: Shard(0) over pp, local
    locals_, specs = [], []
    for leaf in leaves:
        if not isinstance(leaf, DTensor):
            leaf = DTensor.from_local(leaf, amesh, (Replicate(),) * amesh.ndim,
                                      run_check=False)
        want = list(leaf.placements)
        want[pp_dim] = Shard(0)
        if tuple(want) != tuple(leaf.placements):
            leaf = leaf.redistribute(amesh, want)
        locals_.append(leaf.to_local())
        specs.append((without_pp(leaf.placements),
                      (n_layers // s_count,) + tuple(leaf.shape[1:])))

    h_placements = h.placements if isinstance(h, DTensor) else None
    if h_placements is not None:
        if not isinstance(h_placements[pp_dim], Replicate):
            want = list(h_placements)
            want[pp_dim] = Replicate()
            h = h.redistribute(amesh, want)
            h_placements = h.placements
        h_local = h.to_local()
        x_placements = without_pp(h_placements)
    else:
        h_local = h
        x_placements = (Replicate(),) * len(inner_axes)
    rows = h_local.shape[0]
    m_eff = m if rows % m == 0 else math.gcd(rows, m)
    x_shape = (batch // m_eff,) + tuple(h.shape[1:])

    record = torch.is_grad_enabled() and (
        h_local.requires_grad or any(p.requires_grad for p in locals_))
    plan = _Plan(layer_fn, stacked_params, mesh, axis, s_count,
                 mesh.get_local_rank(axis), m_eff, inner, specs, x_placements,
                 x_shape, record)
    out = _GPipe.apply(plan, h_local, *locals_)
    if h_placements is None:
        return out
    return DTensor.from_local(out, amesh, h_placements, run_check=False,
                              shape=h.shape, stride=h.stride())


def _contiguous_stride(shape) -> tuple[int, ...]:
    return torch.empty(shape, device="meta").stride()


class _Plan:
    """What the schedule needs besides the tensors: the layer function, the
    tree, the stage, and how a stage's local blocks wrap on the submesh."""

    def __init__(self, layer_fn, tree, mesh, axis, s_count, stage, m, inner,
                 specs, x_placements, x_shape, record):
        self.layer_fn, self.tree = layer_fn, tree
        self.record = record  # build each tick's graph for the backward
        self.mesh, self.axis = mesh, axis
        self.s_count, self.stage, self.m = s_count, stage, m
        self.inner, self.specs = inner, specs
        self.x_placements, self.x_shape = x_placements, x_shape

    def wrap(self, local, placements, shape):
        if self.inner is None:
            return local
        return DTensor.from_local(local, self.inner, placements, run_check=False,
                                  shape=shape, stride=_contiguous_stride(shape))

    def block(self, x_local, p_locals):
        """This stage's layers on one microbatch (local blocks in, local
        block out, under the submesh)."""
        with use_mesh(self.inner):
            x = self.wrap(x_local, self.x_placements, self.x_shape)
            params = tree_unflatten(self.tree, [
                self.wrap(p, pl, shape) for p, (pl, shape) in zip(p_locals,
                                                                  self.specs)])
            y = _run_layers(self.layer_fn, params, x)
            if isinstance(y, DTensor):
                if tuple(y.placements) != self.x_placements:
                    y = y.redistribute(self.inner, self.x_placements)
                y = y.to_local()
        return y

    def shift(self, x, shift):
        return mesh_ppermute(x, self.mesh, self.axis, shift, wrap=False)


class _GPipe(torch.autograd.Function):
    """The schedule. Forward: M + S - 1 ticks of (stage block, shift one
    stage on), then the last stage's outputs broadcast over pp. Backward:
    the ticks in reverse, each a shift one stage back and the block's
    gradient; the gradient of the input, which stage 0 alone read, summed
    over pp."""

    @staticmethod
    def forward(ctx, plan: _Plan, h_local, *p_locals):
        s, s_count, m = plan.stage, plan.s_count, plan.m
        mb = h_local.reshape((m, h_local.shape[0] // m) + h_local.shape[1:])
        record = plan.record
        p_in = [p.detach().requires_grad_(record) for p in p_locals]
        out = torch.zeros_like(mb)
        ticks = []
        cur = torch.zeros_like(mb[0])
        for t in range(m + s_count - 1):
            j = t - s  # the microbatch this stage holds at tick t
            tick = None
            if 0 <= j < m:
                x = (mb[j] if s == 0 else cur).detach().requires_grad_(record)
                with torch.set_grad_enabled(record):
                    y = plan.block(x, p_in)
                if record:
                    tick = (x, y)
                y = y.detach()
                if s == s_count - 1:
                    out[j] = y
            else:
                y = torch.zeros_like(cur)
            ticks.append(tick)
            cur = plan.shift(y, 1)
        group = plan.mesh.get_group(plan.axis)
        dist.broadcast(out, src=dist.get_global_rank(group, s_count - 1),
                       group=group)
        ctx.plan, ctx.ticks, ctx.p_in = plan, ticks, p_in
        ctx.row_shape = mb.shape
        return out.reshape(h_local.shape)

    @staticmethod
    def backward(ctx, g_out):
        plan, ticks, p_in = ctx.plan, ctx.ticks, ctx.p_in
        s, s_count, m = plan.stage, plan.s_count, plan.m
        g_out = g_out.reshape(ctx.row_shape)
        g_h = torch.zeros_like(g_out)
        g_params: list = [None] * len(p_in)
        g_recv = torch.zeros_like(g_out[0])
        for t in reversed(range(m + s_count - 1)):
            g_y = plan.shift(g_recv, -1)
            j = t - s
            g_recv = torch.zeros_like(g_recv)
            if ticks[t] is None:
                continue
            if s == s_count - 1:
                g_y = g_out[j]
            x, y = ticks[t]
            ticks[t] = None
            with torch.enable_grad(), use_mesh(plan.inner):
                grads = torch.autograd.grad(y, [x] + p_in, g_y,
                                            allow_unused=True)
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
            if s == 0:
                g_h[j] = grads[0]
            else:
                g_recv = grads[0]
        group = plan.mesh.get_group(plan.axis)
        dist.all_reduce(g_h, group=group)
        g_params = [torch.zeros_like(p) if g is None else g
                    for g, p in zip(g_params, p_in)]
        return (None, g_h.reshape((-1,) + g_h.shape[2:]), *g_params)
