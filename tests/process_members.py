"""Small members for tests/test_torch_process_runtime.py.

The process runtime's members import their class by its module path, so
these live in a module of their own that imports neither JAX nor torch:
a member process built from one starts in well under a second.
"""

import os
import sys
import threading
import time

import numpy as np


def mapped_file(address: int):
    """The base name of the file mapped at ``address`` in this process,
    by /proc/self/maps; None for memory no file backs."""
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split()
            lo, hi = (int(x, 16) for x in parts[0].split("-"))
            if lo <= address < hi:
                return os.path.basename(parts[5]) if len(parts) > 5 else None
    return None


class Recorder:
    """Logs each call's start and end; holds the constructor's ``blob``."""

    def __init__(self, tag: str = "", blob=None):
        self.tag, self.blob = tag, blob
        self.log: list = []
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(2, timeout=20)

    def pid(self) -> int:
        return os.getpid()

    def modules(self) -> list:
        """Which of jax, ray_tpu and torch this process has imported."""
        return sorted(m for m in ("jax", "ray_tpu", "torch")
                      if m in sys.modules)

    def step(self, x, delay: float = 0.0):
        with self._lock:
            self.log.append(("start", x))
        time.sleep(delay)
        with self._lock:
            self.log.append(("end", x))
        return x

    def record(self) -> list:
        with self._lock:
            return list(self.log)

    def meet(self) -> bool:
        """Returns once a second call is in ``meet`` at the same time."""
        self._barrier.wait()
        return True

    def describe(self, tree) -> dict:
        """How a tree arrived here: each array leaf's sum and the name of
        the file its bytes are mapped from (None: not a file's)."""
        if isinstance(tree, dict):
            return {k: self.describe(v) for k, v in tree.items()}
        if isinstance(tree, np.ndarray):
            return {"file": mapped_file(tree.ctypes.data),
                    "sum": float(tree.sum())}
        if type(tree).__name__ == "Tensor":
            return {"file": mapped_file(tree.data_ptr()),
                    "sum": float(tree.float().sum())}
        return {"type": type(tree).__name__}

    def blob_described(self) -> dict:
        return self.describe(self.blob)

    def echo(self, *args, **kwargs):
        return args, kwargs

    def keep(self, x) -> None:
        self.kept = x

    def kept_value(self):
        return self.kept

    def drop(self) -> None:
        self.kept = None

    def off_host_tensor(self):
        import torch

        return torch.empty(2, device="meta")  # a tensor that is not on the CPU

    def sleep(self, seconds: float) -> float:
        time.sleep(seconds)
        return seconds

    def die(self, code: int = 3):
        os._exit(code)


class RefusingInit:
    def __init__(self, why: str):
        raise ValueError(f"refused: {why}")


class DyingInit:
    def __init__(self):
        os._exit(7)
