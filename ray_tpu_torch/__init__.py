"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model stack.

The JAX package ``ray_tpu`` is the reference; this package mirrors its
module paths and public names (``ops``, ``models.llama``,
``models.decode_engine``, ``train``) and imports nothing from it. Importing this
package compiles nothing: the CUDA kernels build on their first launch
(``_kernels.py``).
"""

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
