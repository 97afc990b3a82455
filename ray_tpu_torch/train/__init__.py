"""Training layer: the train step, on one device or a mesh, and the
fused optimizer.

- optim.py: ``fused_adamw`` with bf16 moments and stochastic rounding
- step.py: ``TrainState``, ``batch_sharding``, ``init_train_state``,
  ``make_train_step``
- checkpoint.py: dict checkpoints with crc32 integrity (the MPMD
  pipeline's stage checkpoints), in the JAX package's format

The rest of the JAX package's train runtime (trainers, sharded
checkpoints, DCN) is ROADMAP Queue 1 item 5; nothing of it is imported
here.
"""

from ray_tpu_torch.train.optim import FusedAdamWState, fused_adamw  # noqa: F401
from ray_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    batch_sharding,
    init_train_state,
    make_train_step,
)
