"""Train state and train step, on one device or on a device mesh.

Mirrors ray_tpu/train/step.py (``TrainState``, ``batch_sharding``,
``init_train_state``, ``make_train_step``). On a mesh every leaf of the
state is a DTensor placed by the logical rules (``parallel/sharding.py``)
and the model's ``shard_constraint`` calls place the activations, where
JAX jits the step with NamedShardings and GSPMD inserts the collectives:
one code path covers dp, pp, fsdp, ep, sp and tp by changing the mesh and
the rules only (on pp the layer stack is split over the stages and the
model runs it as a GPipe pipeline, ``parallel/pipeline.py``). Without a
mesh the state is plain tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.profiler import record_function

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.mesh import active_mesh, use_mesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    LogicalRules,
    NamedSharding,
    distribute,
    logical_to_placements,
    logical_tree_to_shardings,
    to_mesh,
)
from ray_tpu_torch.train.optim import FusedAdamW, FusedAdamWState
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten


@dataclasses.dataclass
class TrainState:
    """step / params / opt_state (params are f32 masters)."""
    step: int
    params: dict
    opt_state: Any


def batch_sharding(mesh: DeviceMesh, rules: LogicalRules = DEFAULT_RULES, *,
                   ndim: int = 2) -> NamedSharding:
    """Sharding for a [batch, seq, ...] batch array."""
    names = ("batch", "seq") + (None,) * (ndim - 2)
    return NamedSharding(active_mesh(mesh),
                         logical_to_placements(names[:ndim], mesh, rules))


def _path_names(path: str) -> tuple[str, ...]:
    return tuple(path.split("/"))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh`` (raises for CUDA without a card)."""
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _opt_shardings(opt_state: FusedAdamWState, param_shardings: dict):
    """The optimizer state's shardings, by path: each moment leaf takes
    the sharding of the param whose path is a suffix of its own (mu/
    layers/wq ends with layers/wq), as JAX's ``init_train_state`` matches
    them (ray_tpu/train/step.py:94-103). Shape matching would be wrong:
    wq and wo have one shape and transposed shardings. The step count is
    a host int (None)."""
    by_path = {_path_names(path): sh for path, sh in
               zip(tree_paths(param_shardings), tree_leaves(param_shardings))}
    mesh = next(iter(by_path.values())).mesh
    replicated = NamedSharding(mesh, (Replicate(),) * mesh.ndim)

    def match(prefix, tree):
        paths = tree_paths(tree, prefix)
        out = []
        for path, leaf in zip(paths, tree_leaves(tree)):
            names = _path_names(path)
            for start in range(len(names)):
                hit = by_path.get(names[start:])
                if hit is not None and all(p.dim < leaf.ndim for p in hit.placements
                                           if isinstance(p, Shard)):
                    out.append(hit)
                    break
            else:
                out.append(replicated)
        return tree_unflatten(tree, out)

    return FusedAdamWState(None, match("mu/", opt_state.mu),
                           match("nu/", opt_state.nu))


def init_train_state(init_params_fn: Callable, param_axes, optimizer=None,
                     mesh: DeviceMesh | None = None,
                     rules: LogicalRules = DEFAULT_RULES, *, device=None):
    """Create the train state: f32 master params and the optimizer's.

    On a mesh (JAX's argument order): ``init_train_state(init_params_fn,
    param_axes, optimizer, mesh, rules)`` returns ``(state,
    state_shardings)``. ``init_params_fn(device, place)`` makes the params
    on this rank's device and hands each leaf to ``place(path, leaf)`` as
    soon as it is made (e.g. ``lambda dev, place: llama.init_params(cfg,
    gen, dev, master=True, place=place)``); every rank makes the same
    leaves. ``place`` keeps this rank's block of the leaf under the
    sharding that ``param_axes`` gives it (no communication), so at most
    one whole leaf exists at a time, never the whole tree. The moments
    take their params' shardings by path. The mesh's device must be
    there (``cuda`` raises without a card).

    On one device: ``init_train_state(init_params_fn, optimizer, *,
    device=None)`` returns the state, with params from
    ``init_params_fn(device)`` (e.g. ``lambda dev: llama.init_params(cfg,
    gen, dev, master=True)``) on ``device`` (default ``cuda``; raises
    without a card)."""
    if isinstance(param_axes, FusedAdamW):
        if optimizer is not None or mesh is not None:
            raise TypeError("one device: init_train_state(init_params_fn, "
                            "optimizer, *, device)")
        return _init_one_device(init_params_fn, param_axes, device)
    if optimizer is None or mesh is None:
        raise TypeError("on a mesh: init_train_state(init_params_fn, "
                        "param_axes, optimizer, mesh, rules)")
    if device is not None:
        raise TypeError("on a mesh the device is the mesh's")
    dev = _mesh_device(mesh)
    p_sh = logical_tree_to_shardings(param_axes, mesh, rules)
    by_path = dict(zip(tree_paths(p_sh), tree_leaves(p_sh)))
    placed = set()

    def place(path: str, leaf: torch.Tensor) -> DTensor:
        if path not in by_path:
            raise KeyError(f"param {path!r} has no logical axes")
        placed.add(path)
        return distribute(leaf, by_path[path])

    params = init_params_fn(dev, place)
    if placed != set(by_path) or tree_paths(params) != tree_paths(p_sh):
        raise ValueError("init_params_fn must make the tree of param_axes and "
                         f"place every leaf; placed {sorted(placed)}")
    opt_state = optimizer.init(params)
    opt_sh = _opt_shardings(opt_state, p_sh)
    for name in ("mu", "nu"):
        tree, sh = getattr(opt_state, name), getattr(opt_sh, name)
        setattr(opt_state, name, tree_unflatten(tree, [
            x if tuple(x.placements) == s.placements
            else x.redistribute(s.mesh, s.placements)
            for x, s in zip(tree_leaves(tree), tree_leaves(sh))]))
    return (TrainState(0, params, opt_state),
            TrainState(None, p_sh, opt_sh))


def _init_one_device(init_params_fn, optimizer, device) -> TrainState:
    dev = resolve_device(device)
    params = init_params_fn(dev)
    for x in tree_leaves(params):
        if x.device.type != dev.type:
            raise ValueError(f"init_params_fn put a leaf on {x.device}, "
                             f"not {dev}")
    return TrainState(0, params, optimizer.init(params))


def make_train_step(
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    optimizer: FusedAdamW,
    mesh: DeviceMesh | None = None,
    state_shardings: TrainState | None = None,
    rules: LogicalRules = DEFAULT_RULES,
    *,
    compute_grad_norm: bool = True,
    grads_dtype: torch.dtype | None = None,
    device=None,
    sync_grads: Callable[[dict], dict] | None = None,
):
    """Build the train step: (state, batch) -> (state, metrics).

    loss_fn(params, batch) -> (scalar_loss, metrics_dict). The step
    updates the state's masters and moments IN PLACE (JAX's
    ``donate_state=True``) and returns a TrainState holding them with
    step + 1. Every leaf is a floating tensor and is differentiated.
    ``grads_dtype=torch.bfloat16`` differentiates through a bf16 copy of
    every leaf, norms included (one copy per leaf per step, as JAX's
    ``p_low``), so gradients are bf16; the optimizer
    upcasts each one for the f32 master update. ``compute_grad_norm``
    adds the global L2 norm of the gradients, in f32. Its two halves are
    profiler ranges, "train_step.forward_backward" and
    "train_step.optimizer". ``sync_grads(grads) -> grads``, if given, takes
    the gradient tree between the two (a data-parallel worker's
    ``dcn_allreduce_grads``, as a JAX loop calls it between ``jax.grad``
    and the update); the norm is taken after it.

    On a mesh (``mesh`` and the ``state_shardings`` that
    ``init_train_state`` returned) the loss runs under ``use_mesh``; a
    batch leaf that is a plain tensor, which every rank holds whole, is
    placed by ``batch_sharding``; each gradient is brought to its param's
    sharding before the update, which each rank runs on its own blocks;
    the metrics come back as plain tensors, the same on every rank.
    Without a mesh the step runs on ``device`` (default ``cuda``;
    building it raises without a card)."""
    if mesh is None:
        if state_shardings is not None:
            raise TypeError("state_shardings without a mesh")
        resolve_device(device)
    else:
        if state_shardings is None:
            raise TypeError("a mesh step needs the state_shardings that "
                            "init_train_state returned")
        if device is not None:
            raise TypeError("on a mesh the device is the mesh's")
        _mesh_device(mesh)
        grad_shardings = tree_leaves(state_shardings.params)

    def forward_backward(state, batch):
        inputs = [(p.detach() if grads_dtype is None
                   else p.detach().to(grads_dtype)).requires_grad_()
                  for p in tree_leaves(state.params)]
        loss, metrics = loss_fn(tree_unflatten(state.params, inputs), batch)
        return metrics, torch.autograd.grad(loss, inputs)

    def step(state: TrainState, batch):
        with record_function("train_step.forward_backward"):
            if mesh is None:
                metrics, grads = forward_backward(state, batch)
            else:
                with use_mesh(mesh):
                    batch = {k: to_mesh(v, ("batch", "seq") + (None,) * (v.ndim - 2),
                                        rules)
                             for k, v in batch.items()}
                    metrics, grads = forward_backward(state, batch)
                grads = [g if tuple(g.placements) == sh.placements
                         else g.redistribute(sh.mesh, sh.placements)
                         for g, sh in zip(grads, grad_shardings)]
        if sync_grads is not None:
            grads = tree_leaves(sync_grads(tree_unflatten(state.params, grads)))
        with record_function("train_step.optimizer"):
            opt_state = optimizer.update(tree_unflatten(state.params, grads),
                                         state.opt_state, state.params)
        metrics = {k: (_plain(v) if isinstance(v, torch.Tensor) else v)
                   for k, v in metrics.items()}
        if compute_grad_norm:
            sq = torch.stack([_plain(torch.linalg.vector_norm(g, dtype=torch.float32))
                              for g in grads])
            metrics["grad_norm"] = torch.linalg.vector_norm(sq)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step


def _plain(x: torch.Tensor) -> torch.Tensor:
    """A detached plain tensor: a DTensor's whole value, on every rank."""
    x = x.detach()
    return x.full_tensor() if isinstance(x, DTensor) else x
