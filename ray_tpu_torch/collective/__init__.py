"""Collectives: over the axes of a device mesh (``mesh_ops.py``), and
between the members of a group on the host (``collective.py`` over the
ring of ``ring.py`` and the codecs of ``compression.py``), the port's
counterparts of ray_tpu/collective/.
"""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    CollectiveAbortError,
    CollectiveTimeoutError,
    Group,
    LocalFabric,
    SocketFabric,
    abort_all_local,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    reduce,
    reducescatter,
    reform_group,
)
from ray_tpu_torch.collective.compression import (  # noqa: F401
    Codec,
    get_codec,
)
from ray_tpu_torch.collective.mesh_ops import (  # noqa: F401
    mesh_all_to_all,
    mesh_allgather,
    mesh_allreduce,
    mesh_broadcast,
    mesh_ppermute,
    mesh_reducescatter,
)
from ray_tpu_torch.collective.ring import (  # noqa: F401
    OpStats,
    last_op_stats,
    ring_allgather,
    ring_allreduce,
    ring_reducescatter,
)
