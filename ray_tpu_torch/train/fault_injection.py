"""Deterministic fault injection for the train runtime's chaos sites.

The port's own copy of the part of ray_tpu/_private/fault_injection.py
that the train runtime fires: process-wide specs (plain dicts) matched
against each ``fire(site, **ctx)`` call, tripping on an exact occurrence
count, so the same spec trips at the same call every run.

    {"site": "checkpoint.save",   # the instrumented site
     "match": {"rank": 1},        # subset-match against fire()'s ctx
     "after": 0,                  # skip the first N matching hits
     "count": 1,                  # then trip on the next N (0 = all)
     "action": "drop",            # die, exit or drop
     "exit_code": 1}              # for exit

``die`` raises :class:`InjectedFault`; ``drop`` is returned for the site
to skip its side effect; ``exit`` ends the calling worker: the exit
handler of the calling thread when one is set, called with the spec's
``exit_code`` (an in-process worker registers one that kills only
itself; a worker in a process of its own one that ends the process
with ``os._exit``, as JAX's does), else ``os._exit``. Sites:
``checkpoint.save`` (per written member; ``drop`` = a torn write),
``checkpoint.restore`` (per restore; ``drop`` = detected bitrot) and
``collective.allreduce`` (per gradient bucket, on either train gang;
ctx group, rank, bucket). :func:`prepare` and :func:`matches` are the
validation and the matching rule, which ``parallel/pipeline_runtime.py``
applies to its per-session specs too.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

ACTIONS = ("die", "exit", "drop")

_specs: list[dict] = []
_lock = threading.Lock()
_thread = threading.local()


class InjectedFault(RuntimeError):
    """A ``die`` action of an armed fault spec."""

    def __init__(self, site: str, ctx: dict):
        self.site, self.ctx = site, ctx
        super().__init__(f"injected fault at {site}: {ctx}")


def prepare(specs: list[dict] | dict | None) -> list[dict]:
    """Validated copies of fault specs with JAX's defaults (after 0,
    count 1, action die, exit_code 1), each counting its matching
    occurrences."""
    if isinstance(specs, dict):
        specs = [specs]
    armed = []
    for s in specs or ():
        action = s.get("action", "die")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        armed.append({"site": s["site"], "match": dict(s.get("match") or {}),
                      "after": int(s.get("after", 0)),
                      "count": int(s.get("count", 1)),
                      "action": action,
                      "exit_code": int(s.get("exit_code", 1)), "seen": 0})
    return armed


def matches(spec: dict, site: str, ctx: dict) -> bool:
    """Whether a prepared spec trips at this ``fire(site, **ctx)`` call:
    the site and ``match`` agree, and this matching occurrence (counted
    here) is past ``after`` and within ``count`` (0: all)."""
    if spec["site"] != site or any(ctx.get(k) != v
                                   for k, v in spec["match"].items()):
        return False
    n = spec["seen"]
    spec["seen"] = n + 1
    return n >= spec["after"] and not (spec["count"]
                                       and n >= spec["after"] + spec["count"])


def configure(specs: list[dict] | dict | None) -> None:
    """Replace the armed specs (None or [] clears them)."""
    armed = prepare(specs)
    with _lock:
        _specs[:] = armed


def clear() -> None:
    with _lock:
        _specs.clear()


def set_exit_handler(handler: Callable[[int], None] | None) -> None:
    """What ``exit`` does on the calling thread: ``handler(exit_code)``
    (None: ``os._exit``)."""
    _thread.exit_handler = handler


def fire(site: str, **ctx: Any) -> str | None:
    """The action a matching spec takes at this call, or None."""
    if not _specs:
        return None
    action = None
    with _lock:
        for s in _specs:
            if matches(s, site, ctx):
                action, code = s["action"], s["exit_code"]
                break
    if action == "die":
        raise InjectedFault(site, ctx)
    if action == "exit":
        handler = getattr(_thread, "exit_handler", None)
        if handler is None:
            os._exit(code)
        handler(code)
    return action
