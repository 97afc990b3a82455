"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for (or defaulting to) ``cuda`` on a host without a card raises: the
port never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev
