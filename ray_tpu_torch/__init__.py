"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model stack.

The JAX package ``ray_tpu`` is the reference; this package mirrors its
module paths and public names (``ops``, ``models.llama``,
``models.decode_engine``, ``train``, ``parallel``, ``collective``) and
imports nothing from it. Importing this
package compiles nothing: the CUDA kernels build on their first launch
(``_kernels.py``). Nor does it import torch: a process that the process
runtime (``serve.process_runtime``) spawns for a member that needs no
torch starts without it. ``resolve_device`` is loaded on first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
