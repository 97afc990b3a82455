"""Members in processes of their own: the port's process runtime.

In the JAX package each member of a pool is a worker process of the
ray_tpu runtime: ``LLMPool`` makes every decode replica and prefill
worker an actor, and the actor-learner loop makes its experience buffer
one. :class:`ProcessRuntime` gives the port that process model with
nothing of ray_tpu. It implements ``serve/runtime.py``'s interface
(``spawn``, ``call``, ``get``, ``wait``, ``put``, ``is_ref``, ``kill``,
``actor_error``, ``is_initialized``) over processes started by
multiprocessing's ``spawn`` method, one a member, plus ``shutdown()``.
It is opt-in (``LLMPool(runtime=ProcessRuntime())``,
``ActorLearnerLoop(runtime=...)``); :class:`InProcessRuntime` stays the
default.

- **Members.** ``spawn`` starts one process, never a fork, since the
  parent may hold a CUDA context. The process imports ``cls`` by its
  module path, builds ``cls(**kwargs)`` and serves up to
  ``max_concurrency`` calls at once on threads of its own. A class of
  ``__main__`` is refused: a spawned process imports the main script
  under another name. One thread of the member reads the calls off its
  pipe in the order they were sent and queues them FIFO to its workers,
  so they start in that order. ``spawn`` returns once the constructor has
  returned. The constructor's exception is raised here, with the
  member's traceback as its cause; a member that dies first raises
  :class:`ActorError`. Each member resolves its own device from its
  kwargs, and on a card holds a CUDA context of its own. A member is a
  daemonic process, so it cannot start processes of its own.
- **Refs.** A call's ref is a ``concurrent.futures.Future``; ``wait``
  returns the same ref objects it was given. ``put`` writes the tree once
  into a file-backed store: a directory of this runtime under
  ``tempfile.gettempdir()``. Tensors go into one ``torch.save`` file,
  numpy arrays of at least ``MAP_MIN_BYTES`` into ``.npy`` files of their
  own, and the rest of the tree is pickled. Its ref pickles as its path.
  A put's ref among a call's top-level arguments, or among the
  constructor's kwargs, is resolved in the member by mapping those files
  (``torch.load(mmap=True, weights_only=True)``,
  ``np.load(mmap_mode="r")``), so its bytes never go through the pipe. A
  ref deeper in an argument arrives as a ref, and ``get`` maps it the
  same way. A call's ref among a call's top-level arguments is resolved
  in this process and its value is sent, after the calls sent before it
  (the pool hands a prefill worker's KV to a replica so). The store holds
  its own bytes, so ``owned`` changes nothing.
- **Freeing.** A put's files are removed once no ref to it is left: none
  in this process and none held by a member. This process keeps one
  ``StoreRef`` object a path, and a ref that comes back from a member is
  that object again. Each message that carries a ref to a member counts
  one borrow of it; the member counts the refs it unpickles and, when
  its last ref to a path dies, hands back as many borrows. A member's
  borrows end with it. A member that has mapped a put's files keeps
  reading them after they are removed (an unlinked file lives on while
  it is mapped). ``shutdown()`` removes the whole store.
- **What crosses.** Arguments and results cross the pipe pickled
  (protocol 5). A tensor that is not on the CPU, in either, raises
  ``TypeError`` naming the method: there is no CUDA IPC, and members
  return host values.
- **Deaths.** ``kill`` sends SIGKILL and reaps the process. Every call in
  flight on it, and every later call, raises :class:`ActorError` from
  ``get``. A member that dies on its own is found by EOF on its pipe,
  with the same effect, so no ``get`` or ``wait`` hangs on a dead
  member. A member whose parent dies sees EOF and exits. ``on_death``,
  if given, is called with the member's handle once its process is
  reaped, killed or not (the process train gang records the death and
  restarts the worker there); it must return quickly.
- **Collective.** ``collective(handles, group_name)`` returns one
  picklable callable a member (``collective.MemberAllreducer``). Passed
  to its member, it becomes there the member's own ``Group`` over a
  ``SocketFabric``: the members talk to each other, not through this
  process, each listening on an ``AF_UNIX`` socket in the store's
  directory and linked to its ring neighbours and to rank 0. A call is
  the ring allreduce (``op="sum"``) of a host f32 vector. A member that
  dies is EOF on its links: the others' calls raise
  ``CollectiveAbortError`` naming the group, the rank and the op.
- **Out of scope.** ``deploy`` and ``http_address`` raise
  ``NotImplementedError``. The policy server and ``run_llm_pool`` run on
  :class:`InProcessRuntime`.
- **Clean-up.** ``shutdown()`` kills and reaps every member and removes
  the store, socket files included. A finalizer does the same when the
  runtime is collected or the interpreter exits.

Nothing here imports torch: a member whose class needs none starts
without it, and a tree with no tensor is stored and mapped without it.
"""

from __future__ import annotations

import collections
import importlib
import io
import itertools
import multiprocessing
import os
import pickle
import queue
import shutil
import sys
import tempfile
import threading
import time
import traceback
import weakref
from concurrent import futures
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from ray_tpu_torch.serve.runtime import ActorError, InProcessRuntime
from ray_tpu_torch.utils.trees import tree_map

SPAWN_TIMEOUT_S = 600.0  # a constructor's deadline (weights to the card)
REAP_TIMEOUT_S = 30.0  # for a killed member to be reaped
MAP_MIN_BYTES = 1 << 16  # smaller arrays are pickled with the tree


class _RemoteTraceback(Exception):
    """A member's traceback, as the cause of the exception it raised."""


class StoreRef:
    """A put's ref: the directory of its tree in the runtime's store.
    Unpickled, it is this process's ref of that path (``_ref``)."""

    __slots__ = ("path", "__weakref__")

    def __init__(self, path: str):
        self.path = path

    def __reduce__(self):
        return _ref, (self.path,)

    def __repr__(self):
        return f"StoreRef({self.path!r})"


# The refs alive in this process, one a path: path -> [weakref, receipts],
# receipts being the borrows a member has received with it.
_live: dict[str, list] = {}
_live_lock = threading.RLock()  # a ref may die under it, in its thread
# In the parent: each put's path -> the members of the runtime that owns it.
_owners: dict[str, list] = {}
# In a member: (path, receipts) of each path whose last ref here died, to
# be handed back to the parent.
_releases: queue.SimpleQueue | None = None


def _ref(path: str) -> StoreRef:
    """This process's ref of ``path``: the one alive, else a new one. A
    member counts each as one receipt of a borrow."""
    with _live_lock:
        entry = _live.get(path)
        ref = entry[0]() if entry is not None else None
        if ref is None:
            ref = StoreRef(path)
            entry = _track(ref)
        if entry is not None and _releases is not None:
            entry[1] += 1
    return ref


def _track(ref: StoreRef):
    """Register ``ref`` as its path's ref here, so that its death frees
    the put (in the parent) or hands back its borrows (in a member).
    None for a path this process does not count."""
    path = ref.path
    if _releases is None and path not in _owners:
        return None
    entry = [None, 0]

    def died(wr):
        with _live_lock:
            if _live.get(path) is entry:
                del _live[path]
        if _releases is not None:
            _releases.put((path, entry[1]))
        else:
            _maybe_free(path)

    entry[0] = weakref.ref(ref, died)
    _live[path] = entry
    return entry


def _maybe_free(path: str) -> None:
    """Remove a put's files if no ref to it is left, here or in a member."""
    with _live_lock:
        entry = _live.get(path)
        if entry is not None and entry[0]() is not None:
            return
        members = _owners.get(path)
        if members is None or any(m.borrows.get(path) for m in members):
            return
        del _owners[path]
    shutil.rmtree(path, ignore_errors=True)


class _Slot:
    """A tensor's or a mapped array's place in a stored tree."""

    __slots__ = ("kind", "index")

    def __init__(self, kind: str, index: int):
        self.kind, self.index = kind, index


def _off_host(obj):
    """The device of a tensor that is not on the CPU, else None."""
    torch = sys.modules.get("torch")  # no torch loaded: no tensor here
    if (torch is not None and isinstance(obj, torch.Tensor)
            and obj.device.type != "cpu"):
        return obj.device
    return None


def _refuse(what: str, device):
    return TypeError(f"{what}: a tensor on {device} cannot cross a process "
                     "boundary (there is no CUDA IPC); pass host values")


class _HostPickler(pickle.Pickler):
    """Pickles with protocol 5 and refuses tensors that are not on the
    CPU, naming ``what`` (the method) in the error. Lists in ``refs``
    the path of each put's ref it pickles."""

    def __init__(self, file, what: str):
        super().__init__(file, protocol=5)
        self.what = what
        self.refs: list[str] = []

    def reducer_override(self, obj):
        if type(obj) is StoreRef:
            self.refs.append(obj.path)
            return NotImplemented
        device = _off_host(obj)
        if device is not None:
            raise _refuse(self.what, device)
        return NotImplemented


def _dumps(obj, what: str) -> tuple[bytes, list[str]]:
    """``obj`` pickled, and the paths of the put's refs in it."""
    buf = io.BytesIO()
    pickler = _HostPickler(buf, what)
    pickler.dump(obj)
    return buf.getvalue(), pickler.refs


def _exception_bytes(exc: BaseException) -> bytes:
    """``exc`` pickled, or a RuntimeError with its text when it does not
    pickle and load back."""
    try:
        data = pickle.dumps(exc, protocol=5)
        pickle.loads(data)
        return data
    except Exception:  # noqa: BLE001 — its text is what is left
        return pickle.dumps(RuntimeError(f"{type(exc).__name__}: {exc}"))


def _raised(exc_bytes: bytes, tb: str) -> BaseException:
    exc = pickle.loads(exc_bytes)
    exc.__cause__ = _RemoteTraceback(tb)
    return exc


# ---------------- the store ----------------


def _store(tree, path: str) -> None:
    """Write ``tree`` into the new directory ``path``."""
    os.makedirs(path)
    tensors: list = []
    n_arrays = itertools.count()

    def slot(leaf):
        device = _off_host(leaf)
        if device is not None:
            raise _refuse("put", device)
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if (not leaf.is_contiguous() or leaf.storage_offset()
                    or leaf.untyped_storage().nbytes() != leaf.nbytes):
                leaf = leaf.clone()  # torch.save writes whole storages
            tensors.append(leaf)
            return _Slot("pt", len(tensors) - 1)
        if (isinstance(leaf, np.ndarray) and leaf.nbytes >= MAP_MIN_BYTES
                and not leaf.dtype.hasobject):
            i = next(n_arrays)
            np.save(os.path.join(path, f"{i}.npy"), leaf, allow_pickle=False)
            return _Slot("npy", i)
        return leaf

    skeleton = tree_map(slot, tree)
    if tensors:
        import torch

        torch.save(tensors, os.path.join(path, "tensors.pt"))
    with open(os.path.join(path, "tree.pkl"), "wb") as f:
        pickle.dump((skeleton, len(tensors)), f, protocol=5)


def _load(path: str):
    """The tree stored at ``path``, its tensors and large arrays mapped."""
    with open(os.path.join(path, "tree.pkl"), "rb") as f:
        skeleton, n_tensors = pickle.load(f)
    tensors = []
    if n_tensors:
        import torch

        tensors = torch.load(os.path.join(path, "tensors.pt"), mmap=True,
                             weights_only=True)

    def fill(leaf):
        if not isinstance(leaf, _Slot):
            return leaf
        if leaf.kind == "pt":
            return tensors[leaf.index]
        return np.load(os.path.join(path, f"{leaf.index}.npy"), mmap_mode="r")

    return tree_map(fill, skeleton)


def _resolve(x):
    """A top-level argument, in the member: a put's ref mapped."""
    return _load(x.path) if isinstance(x, StoreRef) else x


# ---------------- the member's side ----------------


def _member_main(conn, max_concurrency: int) -> None:
    """A member process: build the member from the first message, then
    serve calls until the pipe closes."""
    global _releases
    t_entry = time.monotonic()  # the interpreter is up, __main__ imported
    _releases = queue.SimpleQueue()
    try:
        module, qualname, payload = pickle.loads(conn.recv_bytes())
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        kwargs = pickle.loads(payload)
        obj = cls(**{k: _resolve(v) for k, v in kwargs.items()})
        del kwargs  # its refs are handed back once the member drops them
    except BaseException as e:  # noqa: BLE001 — raised in the parent
        conn.send_bytes(pickle.dumps(
            ("error", _exception_bytes(e), traceback.format_exc())))
        return
    conn.send_bytes(pickle.dumps(
        ("ready", os.getpid(), t_entry, time.monotonic())))
    send_lock = threading.Lock()
    threading.Thread(target=_hand_back, args=(conn, send_lock),
                     name="releases", daemon=True).start()
    workers = ThreadPoolExecutor(max_workers=max_concurrency,
                                 thread_name_prefix="member")
    while True:
        try:
            data = conn.recv_bytes()
        except (EOFError, OSError):
            os._exit(0)  # the parent is gone: so is the member
        cid, method, payload = pickle.loads(data)
        workers.submit(_serve_call, obj, conn, send_lock, cid, method,
                       payload)


def _hand_back(conn, send_lock) -> None:
    """Send the parent the borrows of each path whose last ref here died."""
    while True:
        path, n = _releases.get()
        with send_lock:
            conn.send_bytes(pickle.dumps((None, "release", path, n)))


def _serve_call(obj, conn, send_lock, cid: int, method: str,
                payload: bytes) -> None:
    try:
        args, kwargs = pickle.loads(payload)
        out = getattr(obj, method)(
            *[_resolve(a) for a in args],
            **{k: _resolve(v) for k, v in kwargs.items()})
        reply = (cid, "ok", _dumps(out, method)[0])
    except BaseException as e:  # noqa: BLE001 — delivered through get()
        reply = (cid, "error", _exception_bytes(e), traceback.format_exc())
    with send_lock:
        conn.send_bytes(pickle.dumps(reply, protocol=5))


# ---------------- the parent's side ----------------


class Member:
    """The process runtime's handle of one member: its ``name``, its
    process (``process``, ``pid``), the calls in flight on it, and what
    its spawn took: ``boot_s`` from the start of ``spawn`` until the new
    interpreter ran the member's code (imports included), ``build_s``
    for its class's import and constructor. ``borrows`` counts the put
    refs sent to it that it has not handed back, by path."""

    def __init__(self, name: str, process, conn):
        self.name = name
        self.process = process
        self.pid = process.pid
        self.conn = conn
        self.boot_s = self.build_s = None
        self.lock = threading.Lock()  # calls, dead
        self.send_lock = threading.Lock()  # the order of sends, backlog
        self.calls: dict[int, Future] = {}
        self.ids = itertools.count()
        # calls that wait on a call's ref, and every call sent after one
        self.backlog: collections.deque = collections.deque()
        self.draining = False
        self.dead = False
        self.borrows: collections.Counter = collections.Counter()
        # the reader thread reaps the process (one thread waits on it);
        # until that thread starts, whoever kills it reaps it
        self.reader: threading.Thread | None = None
        self.reaped = threading.Event()

    def __repr__(self):
        return f"Member({self.name!r}, pid={self.pid})"


def _kill_and_reap(member: Member) -> None:
    member.process.kill()  # SIGKILL, unless it is reaped already
    if member.reader is None:
        member.process.join(REAP_TIMEOUT_S)
    else:
        member.reaped.wait(REAP_TIMEOUT_S)


def _cleanup(members: list, root: str) -> None:
    """Kill and reap every member, remove the store (the finalizer's
    work: it holds no reference to the runtime)."""
    for member in list(members):
        _kill_and_reap(member)
    with _live_lock:
        for path in [p for p, m in _owners.items() if m is members]:
            del _owners[path]
    shutil.rmtree(root, ignore_errors=True)


def _bury(member: Member) -> None:
    """A dead member's borrows end: free what they alone kept."""
    with _live_lock:
        member.dead = True
        paths = list(member.borrows)
        member.borrows.clear()
    for path in paths:
        _maybe_free(path)


class ProcessRuntime:
    """Members in processes of their own (see the module docstring)."""

    actor_error = ActorError

    def __init__(self, *, on_death=None):
        self._on_death = on_death
        self._ctx = multiprocessing.get_context("spawn")
        self._root = tempfile.mkdtemp(prefix="ray_tpu_torch_store_")
        self._members: list[Member] = []
        self._puts = itertools.count()
        self._groups = itertools.count()
        self._closed = False
        self._finalizer = weakref.finalize(self, _cleanup, self._members,
                                           self._root)

    # ---- members ----

    def spawn(self, cls, kwargs: dict, *, name: str = "",
              max_concurrency: int = 1) -> Member:
        if self._closed:
            raise RuntimeError("the process runtime is shut down")
        if cls.__module__ == "__main__":
            raise ValueError(
                f"{cls.__qualname__} is defined in __main__: a member's "
                "class must live in a module its process can import")
        name = name or cls.__name__
        t0 = time.monotonic()
        payload, refs = _dumps(dict(kwargs), f"{name}.__init__")
        conn, child_conn = self._ctx.Pipe()
        process = self._ctx.Process(
            target=_member_main, args=(child_conn, max(1, int(max_concurrency))),
            name=f"member:{name}", daemon=True)
        process.start()
        child_conn.close()
        member = Member(name, process, conn)
        self._members.append(member)
        try:
            self._lend(member, refs)
            conn.send_bytes(pickle.dumps(
                (cls.__module__, cls.__qualname__, payload), protocol=5))
            if not conn.poll(SPAWN_TIMEOUT_S):
                raise TimeoutError(f"{name} was not built within "
                                   f"{SPAWN_TIMEOUT_S} s")
            status = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            _kill_and_reap(member)
            _bury(member)
            raise ActorError(f"{name} died before its constructor returned "
                             f"(exit code {process.exitcode})") from None
        except BaseException:
            _kill_and_reap(member)
            _bury(member)
            raise
        if status[0] == "error":
            _kill_and_reap(member)
            _bury(member)
            raise _raised(status[1], status[2])
        member.pid = status[1]
        member.boot_s, member.build_s = status[2] - t0, status[3] - status[2]
        member.reader = threading.Thread(target=self._read, args=(member,),
                                         name=f"{name}.reader", daemon=True)
        member.reader.start()
        return member

    def call(self, handle: Member, method: str, *args, fetch_tags=None,
             **kwargs) -> Future:
        fut: Future = Future()
        waits = any(isinstance(a, Future)
                    for a in itertools.chain(args, kwargs.values()))
        with handle.send_lock:
            with handle.lock:
                if handle.dead:
                    fut.set_exception(ActorError(f"{handle.name} is dead"))
                    return fut
                cid = next(handle.ids)
                handle.calls[cid] = fut
            if waits or handle.backlog:
                handle.backlog.append((cid, method, args, kwargs))
                if not handle.draining:
                    handle.draining = True
                    threading.Thread(target=self._drain, args=(handle,),
                                     name=f"{handle.name}.sender",
                                     daemon=True).start()
                return fut
            try:
                message = _message(cid, method, args, kwargs)
            except BaseException:
                with handle.lock:
                    handle.calls.pop(cid, None)
                raise
            self._send(handle, cid, *message)
        return fut

    def _drain(self, handle: Member) -> None:
        """Send the backlog in order, each call once the calls' refs among
        its arguments have their values."""
        while True:
            with handle.send_lock:
                if not handle.backlog:
                    handle.draining = False
                    return
                cid, method, args, kwargs = handle.backlog[0]
            message = err = None
            try:
                message = _message(cid, method,
                                   [_value(a) for a in args],
                                   {k: _value(v) for k, v in kwargs.items()})
            except BaseException as e:  # noqa: BLE001 — the call's error
                err = e
            with handle.send_lock:
                handle.backlog.popleft()
                if err is not None:
                    self._settle(handle, cid, exc=err)
                else:
                    self._send(handle, cid, *message)

    @staticmethod
    def _lend(handle: Member, refs: list[str]) -> None:
        """Count a borrow of each put's ref in a message to ``handle``."""
        with _live_lock:
            if not handle.dead:
                handle.borrows.update(refs)

    def _send(self, handle: Member, cid: int, data: bytes,
              refs: list[str]) -> None:
        self._lend(handle, refs)
        try:
            handle.conn.send_bytes(data)
        except OSError:
            self._settle(handle, cid, exc=ActorError(f"{handle.name} is dead"))

    def _read(self, handle: Member) -> None:
        """Settle each reply of the member; at EOF, the member is dead."""
        while True:
            try:
                reply = pickle.loads(handle.conn.recv_bytes())
            except (EOFError, OSError):
                break
            cid, status = reply[0], reply[1]
            if status == "release":
                with _live_lock:
                    handle.borrows.subtract({reply[2]: reply[3]})
                    if handle.borrows[reply[2]] <= 0:
                        del handle.borrows[reply[2]]
                _maybe_free(reply[2])
                continue
            try:
                if status == "ok":
                    self._settle(handle, cid, result=pickle.loads(reply[2]))
                else:
                    self._settle(handle, cid, exc=_raised(reply[2], reply[3]))
            except Exception as e:  # noqa: BLE001 — a reply that won't load
                self._settle(handle, cid, exc=e)
        handle.process.join(REAP_TIMEOUT_S)
        self._fail_all(handle, f"{handle.name} died (exit code "
                               f"{handle.process.exitcode})")
        if self._on_death is not None:
            try:
                self._on_death(handle)
            except Exception:  # noqa: BLE001 — the reaping goes on
                traceback.print_exc()
        _bury(handle)
        handle.reaped.set()  # kill() returns with the member's puts freed
        handle.conn.close()

    @staticmethod
    def _settle(handle: Member, cid: int, result=None, exc=None) -> None:
        with handle.lock:
            fut = handle.calls.pop(cid, None)
            if fut is None or fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

    @staticmethod
    def _fail_all(handle: Member, why: str) -> None:
        with handle.lock:
            handle.dead = True
            calls, handle.calls = handle.calls, {}
            for fut in calls.values():
                if not fut.done():
                    fut.set_exception(ActorError(why))

    def kill(self, handle: Member) -> None:
        self._fail_all(handle, f"{handle.name} was killed with the call "
                               "in flight")
        _kill_and_reap(handle)
        _bury(handle)

    # ---- refs ----

    def get(self, refs, timeout: float | None = None, fetch_tags=None):
        def one(ref, left):
            if isinstance(ref, Future):
                return ref.result(left)
            return _resolve(ref)

        if not isinstance(refs, list):
            return one(refs, timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        return [one(r, None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
                for r in refs]

    def wait(self, refs, num_returns: int = 1,
             timeout: float | None = None):
        refs = list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        done = {r for r in refs if not isinstance(r, Future)}
        pending = {r for r in refs if isinstance(r, Future)}
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

    def put(self, tree, *, owned: bool = False) -> StoreRef:
        if isinstance(tree, StoreRef):
            return tree
        path = os.path.join(self._root, f"put-{next(self._puts)}")
        _store(tree, path)
        with _live_lock:
            _owners[path] = self._members
            return _ref(path)

    def is_ref(self, x) -> bool:
        return isinstance(x, (Future, StoreRef))

    # ---- the runtime ----

    def is_initialized(self) -> bool:
        return not self._closed

    def shutdown(self) -> None:
        """Kill and reap every member and remove the store."""
        self._closed = True
        for member in list(self._members):
            self.kill(member)
        self._finalizer()

    def collective(self, handles, group_name: str) -> list:
        """One callable a member, in rank order (the module docstring)."""
        from ray_tpu_torch.collective import collective as coll

        addresses = coll.socket_addresses(self._root, str(next(self._groups)),
                                          len(handles))
        authkey = os.urandom(16)
        return [coll.MemberAllreducer(group_name, len(handles), r, addresses,
                                      authkey)
                for r in range(len(handles))]

    def deploy(self, cls, **kwargs):
        raise NotImplementedError(
            "ProcessRuntime has no HTTP ingress: deploy on "
            f"{InProcessRuntime.__name__}")

    def http_address(self):
        raise NotImplementedError(
            "ProcessRuntime has no HTTP ingress: see "
            f"{InProcessRuntime.__name__}")


def _value(x):
    """A top-level argument in this process: a call's ref waited for."""
    return x.result() if isinstance(x, Future) else x


def _message(cid: int, method: str, args, kwargs) -> tuple[bytes, list]:
    """One call on the pipe: its id and method, then its arguments
    pickled apart, so that the member can answer a call whose arguments
    do not load; and the paths of the put's refs among them."""
    payload, refs = _dumps((tuple(args), kwargs), method)
    return pickle.dumps((cid, method, payload), protocol=5), refs
