"""Process groups: one process per rank, one device per process.

JAX runs one process per host and sees every local device; torch runs
one process per device. ``init_process`` joins this process to a world
and ``spawn`` starts a whole world of them on this host. Device rules, as
for every entry point of the port: the default is ``cuda`` with NCCL,
one card per rank, and asking for more ranks than cards raises (nothing
falls back to gloo or the CPU); ``device="cpu"`` takes gloo. Ranks meet
through a file store under a temporary directory, so worlds that start
side by side on one host never fight over a TCP port.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch._device import resolve_device

# A hung collective fails its world after this long, not the caller's run.
DEFAULT_TIMEOUT_S = 120.0


def _backend(device, world: int) -> tuple[torch.device, str]:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no process-group backend for device {dev}")
    if world > torch.cuda.device_count():
        raise RuntimeError(
            f"{world} ranks need {world} CUDA devices, this host has "
            f"{torch.cuda.device_count()} (NCCL takes one device a rank)")
    return dev, "nccl"


def init_process(rank: int, world: int, device=None, store_path: str | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join rank ``rank`` of a world of ``world`` ranks meeting at the file
    store ``store_path`` (a new temporary file when None, which only a
    world of one can share). Returns this rank's device: ``cuda:rank``
    (NCCL) or ``cpu`` (gloo). End it with
    ``torch.distributed.destroy_process_group()``."""
    dev, backend = _backend(device, world)
    if store_path is None:
        if world != 1:
            raise ValueError("a world of several ranks needs a shared store_path")
        store_path = os.path.join(tempfile.mkdtemp(prefix="ray_tpu_torch_pg_"),
                                  "store")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.FileStore(store_path, world)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout, **kw)
    return dev


def _rank_main(rank, fn, world, device, workdir, timeout_s):
    if device == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    init_process(rank, world, device, os.path.join(workdir, "store"), timeout_s)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device=None,
          timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method), each joined to the world by ``init_process``.
    ``fn`` and ``args`` must pickle: ``fn`` is imported by its module in
    every rank. Returns the ranks' return values, in rank order. If a rank
    raises, the others are killed and its traceback is raised here; if the
    world has not finished after ``timeout_s`` seconds, every rank is
    killed and TimeoutError is raised. A collective that hangs fails its
    rank after ``DEFAULT_TIMEOUT_S`` (or ``timeout_s``, if shorter)."""
    dev, _ = _backend(device, world)
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_world_") as workdir:
        # through a file: start_processes pickles its args into each child's
        # start far more slowly (a 256 KB array cost 8 ranks ~13 s on an
        # 8-core CPU host, torch 2.13)
        with open(os.path.join(workdir, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, dev.type, workdir,
                              min(timeout_s, DEFAULT_TIMEOUT_S)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"world of {world} ranks still running "
                                       f"after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        outs = []
        for rank in range(world):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
