"""How the serving pool reaches its members, and the in-process runtime.

The JAX pool (ray_tpu/serve/llm_pool.py) makes its decode replicas and
prefill workers actors of the ray_tpu runtime and calls them through it
(``ray_tpu.remote``, ``handle.method.remote``, ``ray_tpu.get``, ``put``,
``kill``, ``RayActorError``, ``is_initialized``), and so do the RL
algorithms (ray_tpu/rl/), which also ``wait``. The port imports nothing
of the runtime, so ``LLMPool`` and the port's RL layer
(``ray_tpu_torch.rl``) take each of those calls from a runtime value
passed to them, as the serving wrappers take the runtime's other calls
from ``serve.hooks.Hooks``. A runtime has:

- ``spawn(cls, kwargs, *, name, max_concurrency) -> handle``: a member
  ``cls(**kwargs)`` that serves up to `max_concurrency` calls at once
  (the constructor's arguments come as one dict, so that a member may
  take a ``name`` of its own);
- ``call(handle, method, *args, fetch_tags=None, **kwargs) -> ref``: start
  ``method(*args, **kwargs)`` on the member. Calls on one member start in
  the order they were sent, as an actor's do, so that with
  ``max_concurrency`` 1 they also run in that order and a caller may send
  one and move on. Refs among the top-level arguments are resolved
  before the method runs. ``fetch_tags`` label the transfer of those
  arguments for the runtime's accounting, and a runtime may ignore them;
- ``get(ref or list of refs, timeout) -> value or list``;
- ``wait(refs, num_returns=1, timeout=None) -> (ready, pending)``: the
  first ``num_returns`` refs whose calls have finished (fewer when the
  timeout passes first) and the rest, each list in the order given and
  holding the SAME ref objects, so a caller may key a map by them (the
  RL layer's IMPALA keys its in-flight samples so);
- ``put(tree) -> ref``; ``is_ref(x) -> bool``;
- ``kill(handle)``: the member dies at once;
- ``actor_error``: the exception type that a call on a dead member
  raises, from ``get``;
- ``is_initialized() -> bool``: the runtime is up.

:class:`InProcessRuntime` is the default: members are objects in this
process and each call runs on a thread of its own, in its turn.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent import futures
from concurrent.futures import Future


class ActorError(RuntimeError):
    """A call on a member that was killed, or that was in flight when it
    was: the in-process counterpart of the runtime's actor death."""


class _Member:
    """The in-process runtime's handle: the member object, the calls in
    flight on it, its concurrency bound and the order of its calls (each
    call takes a ticket when it is sent; ``started`` is the ticket whose
    turn it is to start)."""

    def __init__(self, obj, name: str, max_concurrency: int):
        self.obj = obj
        self.name = name
        self.slots = threading.BoundedSemaphore(max(1, int(max_concurrency)))
        self.lock = threading.Lock()
        self.turn = threading.Condition(self.lock)
        self.sent = 0
        self.started = 0
        self.inflight: set = set()
        self.dead = False

    @contextlib.contextmanager
    def slot(self, ticket: int):
        """Hold one of the member's slots, taken in ticket order: wait
        until every earlier call has taken its slot, take one, then let
        the next call take its own."""
        with self.turn:
            self.turn.wait_for(lambda: self.started == ticket)
        try:
            self.slots.acquire()
        finally:
            with self.turn:
                self.started += 1
                self.turn.notify_all()
        try:
            yield
        finally:
            self.slots.release()


def _resolved(x):
    return x.result() if isinstance(x, Future) else x


class InProcessRuntime:
    """Members are objects in this process. Each call runs on a thread of
    its own, at most ``max_concurrency`` at once per member, and the calls
    on a member start in the order they were sent; a call's ref is a
    ``concurrent.futures.Future``. ``put`` returns the tree itself: it is
    not copied, so a caller must not change a published tree in place.
    ``kill`` acts as an actor's death: calls in flight and every later
    call raise :class:`ActorError` at once, and the member's ``abort()``
    (where it has one) stops its threads without draining and releases
    its device state, so that a respawn fits."""

    actor_error = ActorError

    def spawn(self, cls, kwargs: dict, *, name: str = "",
              max_concurrency: int = 1) -> _Member:
        return _Member(cls(**kwargs), name or cls.__name__, max_concurrency)

    def call(self, handle: _Member, method: str, *args, fetch_tags=None,
             **kwargs) -> Future:
        fut: Future = Future()
        with handle.lock:
            if handle.dead:
                fut.set_exception(ActorError(f"{handle.name} is dead"))
                return fut
            handle.inflight.add(fut)
            ticket = handle.sent
            handle.sent += 1
        threading.Thread(target=self._run,
                         args=(handle, fut, ticket, method, args, kwargs),
                         name=f"{handle.name}.{method}", daemon=True).start()
        return fut

    @staticmethod
    def _run(handle: _Member, fut: Future, ticket: int, method: str, args,
             kwargs):
        try:
            try:
                args = [_resolved(a) for a in args]
                kwargs = {k: _resolved(v) for k, v in kwargs.items()}
            except Exception:
                with handle.slot(ticket):  # pass the turn on, then fail
                    raise
            with handle.slot(ticket):
                with handle.lock:
                    obj = handle.obj
                if obj is None:
                    raise ActorError(f"{handle.name} is dead")
                out = getattr(obj, method)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — delivered through get()
            InProcessRuntime._settle(handle, fut, exc=e)
        else:
            InProcessRuntime._settle(handle, fut, result=out)

    @staticmethod
    def _settle(handle: _Member, fut: Future, result=None, exc=None):
        # under the member's lock: kill() fails the calls in flight under
        # it, and a call that finishes after its member died stays failed
        with handle.lock:
            handle.inflight.discard(fut)
            if fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

    def get(self, refs, timeout: float | None = None):
        if not isinstance(refs, list):
            return refs.result(timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        return [f.result(None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
                for f in refs]

    def wait(self, refs, num_returns: int = 1,
             timeout: float | None = None):
        refs = list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        done: set = set()
        pending = set(refs)
        while len(done) < num_returns and pending:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            newly, pending = futures.wait(pending, timeout=left,
                                          return_when=futures.FIRST_COMPLETED)
            if not newly:
                break
            done |= newly
        ready = [r for r in refs if r in done][:num_returns]
        return ready, [r for r in refs if r not in ready]

    def put(self, tree):
        return tree

    def is_ref(self, x) -> bool:
        return isinstance(x, Future)

    def kill(self, handle: _Member) -> None:
        with handle.lock:
            if handle.dead:
                return
            handle.dead = True
            obj, handle.obj = handle.obj, None
            for fut in handle.inflight:
                if not fut.done():
                    fut.set_exception(ActorError(
                        f"{handle.name} was killed with the call in flight"))
            handle.inflight.clear()
        abort = getattr(obj, "abort", None)
        if abort is not None:
            abort()

    def is_initialized(self) -> bool:
        return True
