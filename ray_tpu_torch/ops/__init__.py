"""Compute ops: norms, rotary embeddings, attention, losses.

Attention has hand-written CUDA forward and backward kernels
(ops/flash_attention.py, csrc/flash_fwd.cu, csrc/flash_bwd.cu) beside
plain torch versions of the same contracts, which CPU tensors take.
"""

from ray_tpu_torch.ops.norms import rms_norm  # noqa: F401
from ray_tpu_torch.ops.rope import rotary_embedding, apply_rotary  # noqa: F401
from ray_tpu_torch.ops.attention import attention, attention_reference  # noqa: F401
from ray_tpu_torch.ops.losses import softmax_cross_entropy  # noqa: F401
