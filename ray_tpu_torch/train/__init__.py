"""Training layer: the train step, on one device or a mesh, the fused
optimizer, and the train runtime.

- optim.py: ``fused_adamw`` with bf16 moments and stochastic rounding
- step.py: ``TrainState``, ``batch_sharding``, ``init_train_state``,
  ``make_train_step``
- checkpoint.py: dict and sharded train-state checkpoints with crc32
  integrity, in the JAX package's format; ``CheckpointManager``;
  ``ship_checkpoint`` / ``fetch_checkpoint`` through a runtime's store
- session.py: the worker side (``report``, ``get_checkpoint``,
  ``get_dataset_shard``, ...)
- dcn.py: ``dcn_allreduce_grads``, the bucketed gradient sync
- worker_group.py / backend_executor.py: the worker gang (an injected
  runtime: threads of this process by default, ``ProcessTrainRuntime``
  for a process a worker) and the dcn and torch backends
- trainer.py: ``Trainer.fit`` with in-place elastic resume and gang
  restart (JAX's ``JaxTrainer``)
- fault_injection.py: the runtime's chaos sites
"""

from ray_tpu_torch.train.optim import FusedAdamWState, fused_adamw  # noqa: F401
from ray_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    batch_sharding,
    init_train_state,
    make_train_step,
)
from ray_tpu_torch.train.checkpoint import (  # noqa: F401
    Checkpoint,
    CheckpointCorruptError,
    CheckpointManager,
    fetch_checkpoint,
    restore_state,
    save_state,
    ship_checkpoint,
    verify_checkpoint,
)
from ray_tpu_torch.train import session  # noqa: F401
from ray_tpu_torch.train.dcn import (  # noqa: F401
    dcn_allreduce_grads,
    init_cross_slice_group,
    reform_cross_slice_group,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    Result,
    RunConfig,
    ScalingConfig,
    Trainer,
)
