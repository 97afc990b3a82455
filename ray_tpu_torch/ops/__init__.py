"""Compute ops: norms, rotary embeddings, attention, losses.

Attention has a hand-written CUDA forward kernel (ops/flash_attention.py,
csrc/flash_fwd.cu) beside a plain torch version of the same contract,
which CPU tensors take.
"""

from ray_tpu_torch.ops.norms import rms_norm  # noqa: F401
from ray_tpu_torch.ops.rope import rotary_embedding, apply_rotary  # noqa: F401
from ray_tpu_torch.ops.attention import attention, attention_reference  # noqa: F401
from ray_tpu_torch.ops.losses import softmax_cross_entropy  # noqa: F401
