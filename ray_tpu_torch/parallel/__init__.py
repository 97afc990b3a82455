"""Parallelism layer: device meshes, logical sharding rules, process groups.

Every strategy is a mesh axis (dp / pp / fsdp / ep / sp / tp) and the
logical rules place parameters and activations on it as DTensors. Pipeline
stages over pp (``pipeline_apply``, ``MpmdPipeline``) are the pipelines
slice (ROADMAP Queue 1 item 6). ``launch`` starts the ranks: one process
per device.
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    MeshConfig,
    auto_mesh_config,
    build_mesh,
    local_mesh,
    use_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    LogicalRules,
    logical_to_mesh_spec,
    logical_tree_to_shardings,
    shard_constraint,
)
