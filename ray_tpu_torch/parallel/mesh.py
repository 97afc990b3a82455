"""Device meshes over the ranks of a torch.distributed world.

Mirrors ray_tpu/parallel/mesh.py: the same six axes in the same order,
``MeshConfig``, ``auto_mesh_config`` and the ambient mesh that
``sharding.shard_constraint`` reads. Where JAX lays a ``jax.sharding.Mesh``
over the devices of one process, the port lays a ``DeviceMesh`` over the
ranks of the default process group (one device each; ``launch.py`` starts
them), with the same axis names, so the logical rules need no change.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Canonical mesh axis order, outermost first (ray_tpu/parallel/mesh.py:29):
# dp (pure data parallel), pp (pipeline stages), fsdp (data parallel with
# sharded params), ep (experts), sp (sequence), tp (tensor parallel,
# innermost: the busiest axis takes the nearest ranks).
AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")

_ambient: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis. Product must equal the world size."""

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.ep, self.sp, self.tp)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def describe(self) -> str:
        return "x".join(f"{n}={s}" for n, s in zip(AXES, self.shape) if s > 1) or "1chip"


def build_mesh(config: MeshConfig) -> DeviceMesh:
    """A DeviceMesh with the canonical axis names over every rank of the
    default process group (rank r at row-major position r, so tp is the
    fastest-varying axis). Its device type follows the group's backend:
    NCCL ranks hold CUDA devices, gloo ranks the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process group: start the ranks "
                           "with ray_tpu_torch.parallel.launch")
    world = dist.get_world_size()
    if config.size != world:
        raise ValueError(
            f"MeshConfig {config.shape} (={config.size}) != {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, config.shape, mesh_dim_names=AXES)


def mesh_config(mesh: DeviceMesh) -> MeshConfig:
    """The MeshConfig a mesh of the canonical axes was built from."""
    return MeshConfig(**{name: mesh.size(i)
                         for i, name in enumerate(mesh.mesh_dim_names)})


def auto_mesh_config(
    n_devices: int,
    *,
    want_tp: int = 0,
    want_sp: int = 0,
    want_ep: int = 0,
    want_pp: int = 0,
    prefer_fsdp: bool = True,
) -> MeshConfig:
    """Factor ``n_devices`` into a mesh: the wanted tp, sp, ep and pp
    factors (each the largest divisor of what is left that does not
    exceed the wish), the rest on fsdp (or dp)."""
    rem = n_devices
    tp = _take_factor(rem, want_tp)
    rem //= tp
    sp = _take_factor(rem, want_sp)
    rem //= sp
    ep = _take_factor(rem, want_ep)
    rem //= ep
    pp = _take_factor(rem, want_pp)
    rem //= pp
    if prefer_fsdp:
        fsdp, dp = rem, 1
    else:
        dp, fsdp = rem, 1
    return MeshConfig(dp=dp, pp=pp, fsdp=fsdp, ep=ep, sp=sp, tp=tp)


def _take_factor(n: int, want: int) -> int:
    """Largest divisor of n that is <= want (want==0 means 1)."""
    if want <= 1:
        return 1
    for f in range(min(n, want), 0, -1):
        if n % f == 0:
            return f
    return 1


def active_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The axes of ``mesh`` that have more than one rank (the first axis
    alone when none has)."""
    names = mesh.mesh_dim_names
    return tuple(n for i, n in enumerate(names) if mesh.size(i) > 1) or names[:1]


def active_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The submesh of ``active_axes``: where the DTensors of a mesh live.
    DTensor weighs every strategy of an op on every mesh dim, size-1 dims
    too, so its work grows as a power of the dim count: the first matmul
    of a shape took ~3 s on six dims of size 1 and ~10 ms on one or two
    (torch 2.13 on the CPU). A mesh whose every dim is active is its own
    active mesh (a submesh cannot be sliced again)."""
    axes = active_axes(mesh)
    return mesh if axes == tuple(mesh.mesh_dim_names) else mesh[axes]


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None):
    """Install ``mesh`` as the ambient mesh for the block (None: no mesh,
    as inside a pipeline stage whose only active axis is pp)."""
    token = _ambient.set(None if mesh is None else (mesh, active_mesh(mesh)))
    try:
        yield mesh
    finally:
        _ambient.reset(token)


def current_mesh() -> DeviceMesh | None:
    """The ambient mesh (``use_mesh``), or None outside one."""
    ambient = _ambient.get()
    return None if ambient is None else ambient[0]


def current_active_mesh() -> DeviceMesh | None:
    """``active_mesh`` of the ambient mesh, or None outside one."""
    ambient = _ambient.get()
    return None if ambient is None else ambient[1]


def local_mesh() -> DeviceMesh:
    """Mesh over every rank of the world, everything on fsdp."""
    return build_mesh(auto_mesh_config(dist.get_world_size()))
