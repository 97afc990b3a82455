"""Parallelism layer: device meshes, logical sharding rules, process
groups, pipelines.

Every strategy is a mesh axis (dp / pp / fsdp / ep / sp / tp) and the
logical rules place parameters and activations on it as DTensors. pp
exists at two scales: the in-mesh GPipe microbatch pipeline
(``pipeline.py``: one SPMD program, one ppermute a tick) and the MPMD
pipeline (``mpmd_pipeline.py``: one program per stage, activations
streamed between stages as host arrays over an injected runtime,
``pipeline_runtime.py``). ``launch`` starts the ranks: one process per
device.
"""

from ray_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_stages,
)
from ray_tpu_torch.parallel.mpmd_pipeline import (  # noqa: F401
    MpmdPipeline,
    PipelineResult,
    PipelineSchedule,
    StageSpec,
)
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
