"""Single-device train state and train step.

Mirrors ray_tpu/train/step.py (``TrainState``, ``init_train_state``,
``make_train_step``) for one device. Meshes, logical sharding rules and
the sharded init are ROADMAP Queue 1 item 8 ("Multi-device"); neither
function takes a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.profiler import record_function

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.train.optim import FusedAdamW
from ray_tpu_torch.utils.trees import tree_leaves, tree_unflatten


@dataclasses.dataclass
class TrainState:
    """step / params / opt_state (params are f32 masters)."""
    step: int
    params: dict
    opt_state: Any


def init_train_state(init_params_fn: Callable[[torch.device], dict],
                     optimizer: FusedAdamW, *, device=None) -> TrainState:
    """Params from ``init_params_fn(device)`` (f32 masters, e.g.
    ``lambda dev: llama.init_params(cfg, gen, dev, master=True)``) and the
    optimizer's state, on ``device`` (default ``cuda``; raises without a
    card). One device only: no mesh, no sharded init (ROADMAP Queue 1
    item 8)."""
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
    *,
    compute_grad_norm: bool = True,
    grads_dtype: torch.dtype | None = None,
    device=None,
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
    adds the global L2 norm of the gradients, in f32. The step runs on
    ``device`` (default ``cuda``; building it raises without a card).
    Its two halves are profiler ranges, "train_step.forward_backward" and
    "train_step.optimizer"."""
    resolve_device(device)

    def step(state: TrainState, batch):
        with record_function("train_step.forward_backward"):
            inputs = [(p.detach() if grads_dtype is None
                       else p.detach().to(grads_dtype)).requires_grad_()
                      for p in tree_leaves(state.params)]
            loss, metrics = loss_fn(tree_unflatten(state.params, inputs), batch)
            grads = torch.autograd.grad(loss, inputs)
            del inputs
        with record_function("train_step.optimizer"):
            opt_state = optimizer.update(tree_unflatten(state.params, grads),
                                         state.opt_state, state.params)
        metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                   for k, v in metrics.items()}
        if compute_grad_norm:
            sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                              for g in grads])
            metrics["grad_norm"] = torch.linalg.vector_norm(sq)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step
