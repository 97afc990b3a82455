"""Names for activations that a selective-checkpoint policy may save.

The counterpart of ``jax.ad_checkpoint.checkpoint_name``: the model runs
the ops that produce a named activation inside ``checkpoint_name(name)``,
and a policy given to ``torch.utils.checkpoint`` reads
``current_name()`` while those ops dispatch. The forward and its
recompute run the same code, so both see the same names.
"""

from __future__ import annotations

import contextlib
import contextvars

_current: contextvars.ContextVar = contextvars.ContextVar(
    "checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Ops dispatched inside this block produce the activation ``name``."""
    token = _current.set(name)
    try:
        yield
    finally:
        _current.reset(token)


def current_name() -> str | None:
    return _current.get()
