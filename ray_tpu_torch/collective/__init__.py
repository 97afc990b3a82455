"""Collectives over the axes of a device mesh (``mesh_ops.py``).

The JAX package's process-group collectives over its own RPC (ring,
star, compression) never touch JAX and are not part of the port.
"""

from ray_tpu_torch.collective.mesh_ops import (  # noqa: F401
    mesh_all_to_all,
    mesh_allgather,
    mesh_allreduce,
    mesh_broadcast,
    mesh_ppermute,
    mesh_reducescatter,
)
