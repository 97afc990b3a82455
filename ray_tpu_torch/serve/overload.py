"""The serving pool's typed admission refusals.

The port's copy of the error half of ray_tpu/serve/overload.py: the
ladder levels and the two retryable errors an ``LLMPool`` raises when it
sheds a request (queue bound at level L3) or fast-fails one whose
deadline cannot be met. The guardian that walks the ladder is the
runtime's: it comes in through ``serve.hooks.Hooks.guardian``, and a
hosting runtime may pass its own error classes too
(``Hooks.overloaded_error``, ``Hooks.deadline_error``), so that its
clients catch the types they know.
"""

from __future__ import annotations

#: ladder levels, in escalation order
L0_HEALTHY = 0
L1_SHED_SPECULATION = 1
L2_SQUEEZE_BULK = 2
L3_SHED_ADMISSION = 3

LEVEL_NAMES = ("L0", "L1", "L2", "L3")


class PoolOverloadedError(RuntimeError):
    """Typed, RETRYABLE admission refusal: the pool is shedding load
    (degradation level L3, or a deadline that cannot be met).
    ``retry_after_s`` is the pool's estimate of when capacity returns;
    the request was never admitted, so a retry is always safe."""

    retryable = True

    def __init__(self, tenant: str, reason: str, retry_after_s: float,
                 level: int = L3_SHED_ADMISSION, msg: str = ""):
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.level = int(level)
        super().__init__(
            msg or f"pool overloaded ({LEVEL_NAMES[min(level, 3)]}, "
                   f"{reason}): tenant {tenant!r} shed, retry after "
                   f"{retry_after_s:.2f}s")


class DeadlineExceededError(PoolOverloadedError):
    """Deadline-aware admission refusal: the request's ``deadline_s`` is
    (predicted to be) unmeetable, either fast-failed at admission
    (predicted TTFT from queue depth over the observed service rate
    already past it) or reaped after expiring in the queue. Retryable
    with a fresh deadline; no decode slot was spent."""
