"""How the serving pool reaches its members, and the in-process runtime.

The JAX pool (ray_tpu/serve/llm_pool.py) makes its decode replicas and
prefill workers actors of the ray_tpu runtime and calls them through it
(``ray_tpu.remote``, ``handle.method.remote``, ``ray_tpu.get``, ``put``,
``kill``, ``RayActorError``, ``is_initialized``), and so do the RL
algorithms (ray_tpu/rl/), which also ``wait``; the learner groups add a
collective group, the policy server and ``run_llm_pool`` a Serve
deployment and its HTTP proxy, and checkpoint shipping a store ``put``
that owns its bytes. The port imports nothing
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
- ``get(ref or list of refs, timeout=None, fetch_tags=None) -> value or
  list``: ``fetch_tags`` label the transfer for the runtime's accounting
  (checkpoint shipping passes ``{"qos": "bulk", "owner": "checkpoint"}``),
  and a runtime may ignore them;
- ``wait(refs, num_returns=1, timeout=None) -> (ready, pending)``: the
  first ``num_returns`` refs whose calls have finished (fewer when the
  timeout passes first) and the rest, each list in the order given and
  holding the SAME ref objects, so a caller may key a map by them (the
  RL layer's IMPALA keys its in-flight samples so);
- ``put(tree, *, owned=False) -> ref``; ``is_ref(x) -> bool``. With
  ``owned`` the ref's value owns its bytes: it outlives any buffer the
  tree's arrays view (checkpoint shipping puts views of files it maps
  and closes them right after);
- ``kill(handle)``: the member dies at once;
- ``actor_error``: the exception type that a call on a dead member
  raises, from ``get``;
- ``is_initialized() -> bool``: the runtime is up;
- ``collective(handles, group_name) -> [allreduce_0, ...]``: one callable
  per member, in rank order, ``allreduce_r(float32 vector) -> the sum
  over the members``, which member r calls from inside one of its own
  calls (the learner groups pass each member its callable);
- ``deploy(cls, *, name, route_prefix, init_args=(), init_kwargs=None,
  num_replicas=1, max_concurrent_queries) -> handle``: a deployment of
  ``cls(*init_args, **init_kwargs)`` behind the HTTP ingress, at most
  ``max_concurrent_queries`` calls at once; the handle takes ``call``
  (a POST to ``route_prefix`` is ``call(handle, "__call__", body)``), and
  ``kill`` undeploys it;
- ``http_address() -> (host, port)``: the ingress that serves the
  deployments' routes.

:class:`InProcessRuntime` is the default: members are objects in this
process and each call runs on a thread of its own, in its turn.
``serve.process_runtime.ProcessRuntime`` puts each member in a process
of its own, as the JAX runtime's actors are; it has no ``collective``,
``deploy`` or ``http_address``.
"""

from __future__ import annotations

import contextlib
import functools
import http.server
import json
import threading
import time
from concurrent import futures
from concurrent.futures import Future

import numpy as np

COLLECTIVE_TIMEOUT_S = 120.0  # an in-process allreduce's deadline


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
    not copied (unless ``owned``), so a caller must not change a published
    tree in place; ``get`` gives a put's value back as it is.
    ``kill`` acts as an actor's death: calls in flight and every later
    call raise :class:`ActorError` at once, and the member's ``abort()``
    (where it has one) stops its threads without draining and releases
    its device state, so that a respawn fits. A collective sums the
    members' vectors in rank order (``train.worker_group.Reduce``) and
    raises ``CollectiveTimeoutError`` past its deadline. The first
    ``deploy`` starts one stdlib ``ThreadingHTTPServer`` on 127.0.0.1 at a
    free port; it routes a POSTed JSON body by the longest matching
    ``route_prefix`` to the deployment's ``__call__`` and answers 200 with
    the JSON reply, 500 with ``{"error": ...}`` when the call raised, or
    404 for no route. It is the in-process stand-in for the serving
    layer's proxy and nothing more: no autoscaling, one replica a
    deployment. It stops when its last deployment is killed."""

    actor_error = ActorError

    def __init__(self):
        self._routes: dict[str, _Member] = {}
        self._http: http.server.ThreadingHTTPServer | None = None
        self._http_lock = threading.Lock()

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

    def get(self, refs, timeout: float | None = None, fetch_tags=None):
        def one(ref, left):
            return ref.result(left) if isinstance(ref, Future) else ref

        if not isinstance(refs, list):
            return one(refs, timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        return [one(f, None if deadline is None
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

    def put(self, tree, *, owned: bool = False):
        return _owned_copy(tree) if owned else tree

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
        self._undeploy(handle)
        abort = getattr(obj, "abort", None)
        if abort is not None:
            abort()

    def is_initialized(self) -> bool:
        return True

    def collective(self, handles, group_name: str) -> list:
        from ray_tpu_torch.train.worker_group import Reduce

        def in_rank_order(vectors):
            out = np.array(vectors[0], np.float32)
            for v in vectors[1:]:
                out += v
            return out

        reduce = Reduce(len(handles), in_rank_order)
        return [functools.partial(_allreduce, reduce, rank, handle)
                for rank, handle in enumerate(handles)]

    def deploy(self, cls, *, name: str, route_prefix: str, init_args=(),
               init_kwargs=None, num_replicas: int = 1,
               max_concurrent_queries: int) -> _Member:
        if num_replicas != 1:
            raise ValueError("the in-process runtime deploys one replica "
                             f"a deployment, not {num_replicas}")
        handle = _Member(cls(*init_args, **(init_kwargs or {})), name,
                         max_concurrent_queries)
        with self._http_lock:
            if route_prefix in self._routes:
                raise ValueError(f"route {route_prefix!r} is taken")
            self._routes[route_prefix] = handle
            if self._http is None:
                self._http = _ingress(self)
        return handle

    def http_address(self) -> tuple[str, int]:
        with self._http_lock:
            if self._http is None:
                raise RuntimeError("no deployment: the ingress is not up")
            return self._http.server_address[:2]

    def _route(self, path: str) -> _Member | None:
        with self._http_lock:
            hits = [p for p in self._routes
                    if path == p or path.startswith(p.rstrip("/") + "/")]
            return self._routes[max(hits, key=len)] if hits else None

    def _undeploy(self, handle: _Member) -> None:
        with self._http_lock:
            for prefix in [p for p, h in self._routes.items() if h is handle]:
                del self._routes[prefix]
            server = None
            if not self._routes and self._http is not None:
                server, self._http = self._http, None
        if server is not None:
            server.shutdown()
            server.server_close()


def _allreduce(reduce, rank: int, handle: _Member, vector,
               timeout: float = COLLECTIVE_TIMEOUT_S):
    """Member ``rank``'s side of an in-process collective: its f32 vector
    in, the rank-order sum of every member's out (a fresh array)."""
    def check():
        if handle.dead:
            raise ActorError(f"{handle.name} is dead")

    out = reduce(rank, np.asarray(vector, np.float32), check,
                 time.monotonic() + timeout)
    return out.copy()


def _owned_copy(tree):
    """``tree`` with every numpy array copied into memory of its own,
    dicts, lists and tuples rebuilt."""
    if isinstance(tree, dict):
        return {k: _owned_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_owned_copy(x) for x in tree)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _ingress(runtime: InProcessRuntime) -> http.server.ThreadingHTTPServer:
    """The in-process HTTP ingress, serving on a thread of its own."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — the stdlib's name
            handle = runtime._route(self.path.split("?")[0])
            if handle is None:
                return self._reply(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"null")
                out = runtime.get(runtime.call(handle, "__call__", body))
            except Exception as e:  # noqa: BLE001 — the client's 500
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            self._reply(200, out)

        def _reply(self, status: int, obj):
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):  # no line on stderr a request
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="ingress",
                     daemon=True).start()
    return server
