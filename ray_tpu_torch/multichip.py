"""Multi-device dry run: sharded train steps over n-rank meshes.

    python -m ray_tpu_torch.multichip N [--device cpu]

Mirrors the JAX package's ``dryrun_multichip`` (``__graft_entry__.py:60-165``):
two mesh layouts cover every parallelism axis. First ``n`` factors into
tp, sp, ep and fsdp (powers of two) and dp (the odd rest); then, for even
``n``, a two-stage GPipe pipeline over pp with fsdp and dp for the rest.
Each layout takes one step of the sharded train step on a tiny Llama
(vocab 256, d 64, 2 layers, 4/2 heads, d_ff 128, f32; 4 experts, top-2,
when ep > 1; 2 microbatches when pp > 1) with ``fused_adamw(1e-3)``.
Each rank is one process on one device (``parallel/launch.py``): CUDA
with NCCL unless ``--device cpu`` (gloo); both layouts run in one world.
Rank 0 prints ``dryrun_multichip ok: mesh=... loss=... step=1`` for each
layout once every rank has the same loss.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import train
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

SEQ = 32  # divisible by sp


def dryrun_mesh_config(n: int) -> MeshConfig:
    """JAX's first layout for n devices: a factor of 2 each to tp, sp and
    ep while n is even, the rest of the powers of two to fsdp, the odd
    remainder to dp (it only has to divide the batch)."""
    rem = n
    tp = 2 if rem % 2 == 0 else 1
    rem //= tp
    sp = 2 if rem % 2 == 0 else 1
    rem //= sp
    ep = 2 if rem % 2 == 0 else 1
    rem //= ep
    fsdp = 1
    while rem % 2 == 0:
        fsdp *= 2
        rem //= 2
    return MeshConfig(dp=rem, fsdp=fsdp, ep=ep, sp=sp, tp=tp)


def dryrun_layouts(n: int) -> list[MeshConfig]:
    """JAX's layouts for n devices: ``dryrun_mesh_config(n)``, then, for
    even n, pp=2 with a factor of 2 to fsdp where the rest is even and the
    remainder to dp."""
    layouts = [dryrun_mesh_config(n)]
    if n % 2 == 0:
        rem = n // 2
        fsdp = 2 if rem % 2 == 0 else 1
        layouts.append(MeshConfig(dp=rem // fsdp, pp=2, fsdp=fsdp))
    return layouts


def dryrun_config(mcfg: MeshConfig) -> llama.LlamaConfig:
    """The dry run's model: MoE when the mesh has an ep axis, GPipe
    microbatches when it has a pp axis."""
    return llama.LlamaConfig.tiny(vocab_size=256, d_model=64, n_layers=2,
                                  n_heads=4, n_kv_heads=2, d_ff=128,
                                  dtype="float32",
                                  n_experts=4 if mcfg.ep > 1 else 0, top_k=2,
                                  pipeline_microbatches=2 if mcfg.pp > 1 else 0)


def dryrun_batch_size(mcfg: MeshConfig) -> int:
    """2 rows per dp x fsdp rank; at least 4 on a pp mesh, so that the
    batch splits into the 2 microbatches."""
    rows = 2 * mcfg.dp * mcfg.fsdp
    return max(rows, 4) if mcfg.pp > 1 else rows


def dryrun_batch(mcfg: MeshConfig, vocab: int) -> dict:
    """[dryrun_batch_size(mcfg), SEQ + 1] tokens from seed 1, as
    inputs/targets."""
    toks = np.random.RandomState(1).randint(
        0, vocab, (dryrun_batch_size(mcfg), SEQ + 1))
    toks = torch.from_numpy(toks)
    return {"inputs": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}


def dryrun_params(cfg, device, place=None):
    """The dry run's f32 masters, from seed 0 on the CPU generator."""
    kw = {} if place is None else {"place": place}
    return llama.init_params(cfg, torch.Generator().manual_seed(0), device,
                             master=True, **kw)


def _dryrun_one(rank: int, world: int, mcfg: MeshConfig, params_fn=None,
                batch=None) -> float:
    """One layout's step; ``params_fn(cfg, device, place)`` and ``batch``
    default to ``dryrun_params`` and ``dryrun_batch``."""
    mesh = build_mesh(mcfg)
    cfg = dryrun_config(mcfg)
    params_fn = params_fn or dryrun_params
    opt = train.fused_adamw(1e-3)
    state, state_sh = train.init_train_state(
        lambda dev, place: params_fn(cfg, dev, place),
        llama.param_logical_axes(cfg), opt, mesh)
    step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                                 mesh, state_sh)
    dev = state.params["embed"].device
    if batch is None:
        batch = dryrun_batch(mcfg, cfg.vocab_size)
    batch = {k: v.to(dev) for k, v in batch.items()}
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    losses = [None] * world
    dist.all_gather_object(losses, loss)
    if not all(math.isfinite(x) and x == loss for x in losses):
        raise AssertionError(f"ranks disagree on the loss: {losses}")
    if rank == 0:
        print(f"dryrun_multichip ok: mesh={mcfg.describe()} loss={loss:.4f} "
              f"step={state.step}", flush=True)
    return loss


def _dryrun_rank(rank: int, world: int, layouts) -> list[float]:
    return [_dryrun_one(rank, world, mcfg) for mcfg in layouts]


def dryrun_multichip(n_devices: int, *, device=None) -> list[float]:
    """One sharded train step over ``n_devices`` ranks for each layout of
    ``dryrun_layouts`` (``launch.spawn``: CUDA with NCCL by default,
    raising if the host has fewer cards; ``device="cpu"`` for gloo).
    Returns each layout's step-1 loss."""
    return launch.spawn(_dryrun_rank, n_devices, dryrun_layouts(n_devices),
                        device=device)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks (default: cuda, NCCL)")
    args = ap.parse_args()
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
