"""Training layer: the single-device train step and the fused optimizer.

- optim.py: ``fused_adamw`` with bf16 moments and stochastic rounding
- step.py: ``TrainState``, ``init_train_state``, ``make_train_step``

The JAX package's train runtime (trainers, checkpoints, DCN) is ROADMAP
Queue 1 item 9; nothing of it is imported here.
"""

from ray_tpu_torch.train.optim import FusedAdamWState, fused_adamw  # noqa: F401
from ray_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
)
