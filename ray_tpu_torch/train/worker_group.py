"""The worker gang, in this process: the train runtime's default.

The JAX package's ``WorkerGroup`` (ray_tpu/train/worker_group.py) is a
gang of ray_tpu actors in one placement group. The port imports nothing
of that runtime, so ``BackendExecutor`` takes its gang from an injected
runtime (``BackendExecutor(runtime=...)``), as ``LLMPool`` takes its
members' calls from ``serve/runtime.py`` and ``MpmdPipeline`` its workers
from ``parallel/pipeline_runtime.py``. A runtime has
``worker_group(num_workers, *, resources_per_worker, strategy,
max_restarts)``, which returns a gang with JAX's ``WorkerGroup`` methods
(``probe``, ``heal``, ``grow``, ``init_collective``,
``reform_collective``, ``destroy_collective``, ``execute``,
``execute_single``, ``shutdown``, ``workers``, ``num_workers``) plus
``submit(worker, fn, *args) -> ref`` and ``get(ref, timeout)`` in place
of ``w.execute.remote`` and ``ray_tpu.get`` (``get`` raises the gang's
``actor_error`` for a worker that died); ``processes`` (whether each
worker is a process of its own); and ``record(cat, name, t0, t1,
attrs)``. A worker function gets the worker as its first argument:
``worker_idx``, ``state`` (a dict that lives as long as the worker, so
across warm resumes), ``addr`` (its host's address), and its side of
the collective: ``allreduce(tensor, group, op, *, codec, transport,
timeout, ef_tag)`` on a host tensor, ``abort_collectives(reason)``,
``check()`` (raises if the worker was killed), ``record(...)``, and
optionally ``start_thread(target)`` (the loop's thread), ``exit()`` and
``stream_context()`` (the worker's CUDA stream; what the block enqueued
is done when it exits).

:class:`InProcessGang` holds the kill, abort, quiesce, respawn, reform
and per-member CUDA stream of in-process workers (threads), which both
the train gang here and ``parallel/pipeline_runtime.py`` build on.
:class:`InProcessWorkerGroup` is the train gang: each worker a thread of
this process with a CUDA stream of its own when there is a card, the
collective ``collective/``'s engine (the ring by default, its codecs
and error feedback) over a ``LocalFabric`` of the epoch: a mailbox a
member, each wait looking at the member's kill and the epoch's abort.
A kill ends the worker at its next runtime call and aborts the epoch
under the survivors (a peer's death, as the ring sees it).
``InProcessTrainRuntime`` makes these gangs. It has no processes, so the
``"torch"`` backend (one ``torch.distributed`` group over the workers)
runs on it at world size 1 only.

:class:`ProcessWorkerGroup` is the gang in processes, JAX's process
model: each worker a :class:`ProcessTrainWorker` spawned through
``serve/process_runtime.py``'s ``ProcessRuntime`` (its own interpreter
and, on the card, its own CUDA context), its calls pickled over a pipe
(worker functions travel by reference, so they live in modules a worker
process can import). Its collective is a socket group of
``collective/collective.py`` per epoch (the workers link to each other,
not through the driver), with JAX's epochs: the driver picks each
epoch and the members re-join under it, and a death during a join
aborts the others' joins. A worker's death is its process's: EOF on its
links and on its pipe. ``ProcessTrainRuntime`` makes these gangs
(opt-in; ``InProcessTrainRuntime`` stays the default).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Callable

import torch

from ray_tpu_torch.collective import collective, ring
from ray_tpu_torch.collective.collective import (  # noqa: F401 (re-exported)
    CollectiveAbortError,
    CollectiveTimeoutError,
)
from ray_tpu_torch.serve.process_runtime import ProcessRuntime
from ray_tpu_torch.serve.runtime import ActorError
from ray_tpu_torch.train import fault_injection

logger = logging.getLogger(__name__)

POLL_S = 0.05  # how often a blocked call looks at its kill and abort flags


class WorkerDiedError(RuntimeError):
    """A call on a worker that died (the runtime's actor error)."""


class WorkerKilled(BaseException):
    """Ends a killed worker's thread at its next runtime call. Not an
    Exception, so that no handler in user code takes it for an error."""


class InertRecorder:
    """Drops every span."""

    def record(self, cat, name, t0, t1, attrs=None):
        pass


_thread = threading.local()  # the member incarnation a thread runs for


@dataclasses.dataclass(eq=False)
class Member:
    """One in-process worker place and its incarnation."""

    restarts: int = 0
    dead: bool = False
    killed: bool = False
    incarnation: int = 0
    thread: threading.Thread | None = None
    stream: Any = None  # the member's CUDA stream (InProcessGang.on_stream)


class Epoch:
    """One incarnation of a gang's collectives: aborted as a whole."""

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.aborted = threading.Event()
        self.lock = threading.Lock()


class InProcessGang:
    """Kill, abort, quiesce, respawn and reform of in-process members.
    A subclass lists its members as ``_members``, builds each epoch's
    collectives in :meth:`_new_epoch` and empties what a place held for a
    new incarnation in :meth:`_clear`. ``abort_on_death``: a kill aborts
    the current epoch (the survivors' collectives raise at once)."""

    abort_on_death = False

    def __init__(self, recorder=None):
        self.recorder = recorder or InertRecorder()
        self._epoch: Epoch | None = None
        self._max_restarts = 0
        self._name = ""

    def _new_epoch(self, epoch: int) -> Epoch:
        return Epoch(epoch)

    def _clear(self, member: Member) -> None:
        """What a new incarnation of ``member`` must not inherit."""

    def check(self, member: Member, epoch: Epoch | None = None) -> None:
        """Raise :class:`WorkerKilled` in a killed member's thread (or in
        a thread of an earlier incarnation), :class:`CollectiveAbortError`
        if ``epoch`` was aborted."""
        mine = getattr(_thread, "incarnations", {}).get(id(member))
        if member.killed or (mine is not None and mine != member.incarnation):
            raise WorkerKilled()
        if epoch is not None and epoch.aborted.is_set():
            rank = getattr(member, "coll_rank", getattr(member, "rank", -1))
            raise CollectiveAbortError(self._name, rank, epoch.epoch, None,
                                       "the collective epoch was aborted")

    def spawn_thread(self, member: Member, target: Callable, args=(),
                     name: str = "") -> threading.Thread:
        """Start ``target(*args)`` as a thread of ``member``'s current
        incarnation."""
        inc = member.incarnation

        def run():
            _thread.incarnations = {id(member): inc}
            target(*args)

        t = threading.Thread(target=run, name=name or self._name, daemon=True)
        t.start()
        return t

    @contextlib.contextmanager
    def on_stream(self, member: Member):
        """The calling thread on ``member``'s CUDA stream (none without a
        card); what the block enqueued is done when it exits."""
        if not torch.cuda.is_available():
            yield
            return
        stream = member.stream
        if stream is None:
            stream = member.stream = torch.cuda.Stream()
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            stream.synchronize()

    def kill(self, member: Member) -> None:
        """The member dies: its thread ends at its next runtime call."""
        member.killed = member.dead = True
        if self.abort_on_death and self._epoch is not None:
            self._epoch.aborted.set()
        now = time.monotonic()
        self.record("runtime", "worker.killed", now, now,
                    {"member": getattr(member, "worker_idx", None)})

    def alive(self, member: Member) -> bool:
        return not member.dead

    def respawn(self, member: Member) -> None:
        """A fresh incarnation in a dead member's place (raises past
        ``max_restarts`` respawns of one place)."""
        if member.restarts >= self._max_restarts:
            raise RuntimeError(f"{self._name}: a worker used its "
                               f"{self._max_restarts} restarts")
        member.restarts += 1
        self.renew(member)

    def renew(self, member: Member) -> None:
        """A new incarnation in ``member``'s place, outside any respawn
        budget: the threads of earlier ones end at their next runtime
        call, and the place keeps none of what :meth:`_clear` empties."""
        member.incarnation += 1
        member.dead = member.killed = False
        member.stream = None
        self._clear(member)

    def reform(self) -> int:
        """Abort the current epoch; the next one gets new collectives."""
        old = self._epoch
        old.aborted.set()
        self._epoch = self._new_epoch(old.epoch + 1)
        return self._epoch.epoch

    def quiesce(self, timeout: float) -> list:
        """Abort the current epoch and join every member's thread; returns
        the members whose thread did not end in time."""
        if self._epoch is not None:
            self._epoch.aborted.set()
        deadline = time.monotonic() + timeout
        stuck = []
        for m in self._members:
            if m.thread is not None:
                m.thread.join(max(0.0, deadline - time.monotonic()))
                if m.thread.is_alive():
                    stuck.append(m)
        return stuck

    def record(self, cat, name, t0, t1, attrs=None) -> None:
        self.recorder.record(cat, name, t0, t1, attrs)


class _TrainEpoch(Epoch):
    """One epoch of the train gang's collective: a ``LocalFabric`` over
    its members (in rank order) and each member's ``Group`` on it."""

    def __init__(self, epoch: int, name: str, gang, workers: list):
        super().__init__(epoch)
        self.name = name
        self.fabric = collective.LocalFabric(len(workers), self._check)
        self.groups = [collective.Group(name, len(workers), r, self.fabric,
                                        epoch=epoch)
                       for r in range(len(workers))]
        self._gang, self._workers = gang, workers

    def _check(self, rank: int) -> dict | None:
        # the waiting member's own kill ends its thread; the epoch's
        # abort ends the op under every member
        self._gang.check(self._workers[rank])
        if self.aborted.is_set():
            return {"reason": f"collective epoch {self.epoch} aborted"}
        return None


@dataclasses.dataclass(eq=False)
class TrainWorker(Member):
    """A train worker: what worker functions get as their first argument."""

    worker_idx: int = 0
    gang: Any = None
    addr: str = "127.0.0.1"
    _actor_id: bytes = b""
    state: dict = dataclasses.field(default_factory=dict)
    coll_rank: int | None = None

    def check(self) -> None:
        self.gang.check(self)

    def exit(self, code: int = 1) -> None:
        """The ``exit`` fault action: this worker dies, here."""
        self.gang.kill(self)
        raise WorkerKilled()

    def start_thread(self, target) -> threading.Thread:
        """Start the worker's loop thread (of this incarnation), which the
        gang's quiesce joins."""
        self.thread = self.gang.spawn_thread(
            self, target, name=f"{self.gang._name}-loop-{self.worker_idx}")
        return self.thread

    def stream_context(self):
        """This worker's CUDA stream; what the block enqueued is done when
        it exits (:meth:`InProcessGang.on_stream`)."""
        return self.gang.on_stream(self)

    def record(self, cat, name, t0, t1, attrs=None) -> None:
        self.gang.record(cat, name, t0, t1, attrs)

    def abort_collectives(self, reason: str = "") -> None:
        ep = self.gang._epoch
        if ep is not None:
            ep.aborted.set()

    def allreduce(self, tensor, group_name: str, op: str = "sum", *,
                  codec=None, transport=None, timeout: float | None = None,
                  ef_tag: str | None = None, out=None):
        """``op`` over the gang's members of a host tensor (every member
        passes one of the same shape and dtype) through
        ``collective.allreduce``: ``transport`` ring (default) or star,
        ``codec`` none, bf16 or int8, error feedback under ``ef_tag``.
        The result is new, of the input's kind, unless ``out`` is given
        (``collective.allreduce``): ``tensor`` is never written to
        otherwise."""
        ep = self.gang._epoch
        if ep is None or ep.name != group_name:
            raise ValueError(f"no collective group {group_name!r}")
        self.gang.check(self, ep)
        fault_injection.fire("collective.allreduce", group=group_name,
                             rank=self.coll_rank, bucket=ef_tag)
        return collective.allreduce(ep.groups[self.coll_rank], tensor, op,
                                    codec=codec, transport=transport,
                                    timeout=timeout, ef_tag=ef_tag, out=out)


class InProcessWorkerGroup(InProcessGang):
    """``num_workers`` train workers as threads of this process (module
    docstring). ``max_restarts`` bounds the respawns :meth:`heal` makes
    (a fresh worker, new identity, in a dead one's place: JAX's
    driver-side budget over the gang); with ``runtime_restarts`` it is
    also each worker's own restart in place by the runtime (JAX's actor
    ``max_restarts``, :meth:`respawn`): same identity, empty state."""

    abort_on_death = True
    actor_error = WorkerDiedError
    processes = False

    def __init__(self, num_workers: int, *, max_restarts: int = 0,
                 runtime_restarts: bool = False, recorder=None,
                 addr: str = "127.0.0.1", name: str = "train"):
        super().__init__(recorder)
        self._name = name
        self.num_workers = num_workers
        self.max_restarts = self._max_restarts = max_restarts
        self._respawns_left = max_restarts
        self.runtime_restarts = runtime_restarts
        self._addr = addr
        self._bundle_count = num_workers
        self._next_worker_idx = 0
        self._coll_group: str | None = None
        self.workers = [self._new_worker() for _ in range(num_workers)]
        self.collective_ranks = list(range(num_workers))

    @property
    def _members(self):
        return self.workers

    def _new_epoch(self, epoch: int) -> _TrainEpoch:
        return _TrainEpoch(epoch, self._coll_group, self, list(self.workers))

    def _clear(self, member: TrainWorker) -> None:
        member.state = {}

    def _identify(self, w: TrainWorker) -> TrainWorker:
        """Give ``w`` the gang's next worker identity."""
        w.worker_idx = self._next_worker_idx
        w._actor_id = f"{self._name}-{w.worker_idx}".encode()
        self._next_worker_idx += 1
        return w

    def _new_worker(self) -> TrainWorker:
        return self._identify(TrainWorker(gang=self, addr=self._addr))

    def kill(self, member: TrainWorker) -> None:
        super().kill(member)
        if (self.runtime_restarts and member.restarts < self.max_restarts
                and member in self.workers):
            self.respawn(member)  # by the runtime, in place: same identity

    # ---- calls ----

    def submit(self, w: TrainWorker, fn: Callable, *args, **kwargs):
        """Run ``fn(w, *args, **kwargs)`` on a thread of ``w``; a future."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut.worker, fut.incarnation = w, w.incarnation
        if w.dead:
            fut.set_exception(WorkerDiedError(f"worker {w.worker_idx} is dead"))
            return fut

        def call():
            try:
                fut.set_result(fn(w, *args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — handed to get()
                fut.set_exception(e)

        self.spawn_thread(w, call, name=f"{self._name}-call-{w.worker_idx}")
        return fut

    def get(self, refs, timeout: float | None = None):
        """The result of a future (or a list of them); raises
        :class:`WorkerDiedError` for a worker that died under the call,
        ``TimeoutError`` past ``timeout``."""
        if isinstance(refs, list):
            deadline = None if timeout is None else time.monotonic() + timeout
            return [self.get(r, None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                    for r in refs]
        try:
            out = refs.result(timeout)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(f"call on worker {refs.worker.worker_idx} "
                               f"outlived {timeout} s") from None
        except WorkerKilled:
            raise WorkerDiedError(f"worker {refs.worker.worker_idx} died") from None
        w = refs.worker
        if w.dead or w.incarnation != refs.incarnation:
            raise WorkerDiedError(f"worker {w.worker_idx} died")
        return out

    def execute_async(self, fn, *args, **kwargs) -> list:
        return [self.submit(w, fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn, *args, timeout: float = 600.0, **kwargs) -> list:
        return self.get(self.execute_async(fn, *args, **kwargs), timeout)

    def execute_single(self, idx: int, fn, *args, **kwargs):
        return self.get(self.submit(self.workers[idx], fn, *args, **kwargs), 600)

    # ---- elastic membership (JAX's WorkerGroup.probe / heal / grow) ----

    def probe(self, timeout: float = 5.0, indices: list[int] | None = None
              ) -> list[bool]:
        idxs = range(len(self.workers)) if indices is None else indices
        return [self.alive(self.workers[i]) for i in idxs]

    def heal(self, *, wait_restart_s: float = 60.0, respawn: bool = True) -> int:
        """Respawn each dead member (a fresh worker in its place) while the
        respawn budget lasts, else drop it (shrink). Returns the world
        size; follow with :meth:`reform_collective`."""
        dead = [i for i, ok in enumerate(self.probe()) if not ok]
        for i in list(dead):
            if not respawn or self._respawns_left <= 0:
                break
            self._respawns_left -= 1
            w = self._identify(self.workers[i])
            w.restarts = 0  # a new actor has its own runtime restarts
            self.renew(w)
            dead.remove(i)
            logger.info("train worker %d respawned (%d respawns left)",
                        i, self._respawns_left)
        if dead:
            gone = set(dead)
            self.workers = [w for i, w in enumerate(self.workers) if i not in gone]
            logger.warning("worker group shrunk: dropped dead ranks %s, world "
                           "size now %d", sorted(gone), len(self.workers))
        self.num_workers = len(self.workers)
        if self.num_workers == 0:
            raise RuntimeError("worker group lost every member")
        return self.num_workers

    def grow(self, num_workers: int, timeout: float = 60.0) -> int:
        """Add fresh workers up to ``num_workers`` (at most the size the
        gang started with). Follow with :meth:`reform_collective`."""
        if num_workers > self._bundle_count:
            raise ValueError(f"cannot grow to {num_workers}: the gang started "
                             f"with {self._bundle_count}")
        while len(self.workers) < num_workers:
            self.workers.append(self._new_worker())
        self.num_workers = len(self.workers)
        return self.num_workers

    # ---- the collective ----

    def _rank_members(self) -> None:
        for r, w in enumerate(self.workers):
            w.coll_rank = r
        self.collective_ranks = list(range(len(self.workers)))

    def init_collective(self, group_name: str | None = None,
                        backend: str = "cpu", **_) -> str:
        self._coll_group = group_name or f"{self._name}-dcn"
        self._rank_members()
        self._epoch = self._new_epoch(1)
        return self._coll_group

    def reform_collective(self, group_name: str | None = None,
                          timeout: float = 120.0, **_) -> str:
        """The members re-rendezvous under the next epoch; the old epoch
        is aborted."""
        name = group_name or self._coll_group
        if not name or self._epoch is None:
            raise RuntimeError("no collective group to reform")
        self._coll_group = name
        self._rank_members()
        self.reform()
        ring.purge_group(name)  # a new incarnation folds no old residual
        return name

    def destroy_collective(self) -> None:
        if self._epoch is not None:
            self._epoch.aborted.set()
        if self._coll_group is not None:
            ring.purge_group(self._coll_group)
        self._epoch = None
        self._coll_group = None

    def shutdown(self, timeout: float = 10.0) -> list:
        """Abort the collective and join every worker's loop thread;
        returns the workers whose loop did not end in time."""
        stuck = self.quiesce(timeout)
        self.destroy_collective()
        self.workers = []
        return stuck


class InProcessTrainRuntime:
    """Makes :class:`InProcessWorkerGroup` gangs (module docstring).
    ``recorder`` takes the spans (``record(cat, name, t0, t1, attrs)``;
    inert when None): ``train.step`` per report, ``train.checkpoint_save``,
    ``train.resume``, ``worker.killed``. ``runtime_restarts``: a dead
    worker is restarted in place by the runtime (up to ``max_restarts``
    times), as JAX's control plane restarts an actor."""

    processes = False

    def __init__(self, recorder=None, *, runtime_restarts: bool = False,
                 addr: str = "127.0.0.1"):
        self.recorder = recorder or InertRecorder()
        self.runtime_restarts = runtime_restarts
        self.addr = addr

    def worker_group(self, num_workers: int, *, resources_per_worker=None,
                     strategy: str = "SPREAD", max_restarts: int = 0
                     ) -> InProcessWorkerGroup:
        """Threads: ``resources_per_worker`` and ``strategy`` are ignored."""
        return InProcessWorkerGroup(num_workers, max_restarts=max_restarts,
                                    runtime_restarts=self.runtime_restarts,
                                    recorder=self.recorder, addr=self.addr)

    def record(self, cat, name, t0, t1, attrs=None) -> None:
        self.recorder.record(cat, name, t0, t1, attrs)


# ---------------------------------------------------------------------------
# the gang in processes
# ---------------------------------------------------------------------------

# calls a worker process runs at once: the result poll, a quiesce, a join
# and its abort, a probe's ping
MEMBER_CONCURRENCY = 8
JOIN_POLL_S = 0.05  # how often the driver looks at the members of a join
EPOCH_QUERY_S = 5.0  # a reform's deadline for the members' live epochs


class ProcessTrainWorker:
    """A train worker in a process of its own: the member class of
    :class:`ProcessWorkerGroup`, and what worker functions get as their
    first argument there. ``state`` lives as long as the process, so a
    survivor keeps its device state across a warm resume. Its collective
    is the process's socket group (``collective.init_collective_group`` /
    ``reform_group``, joined when the driver says); ``exit`` ends the
    process. The spans it records go back to the driver with the reply
    of its next call. On ``device="cuda"`` it raises without a card."""

    def __init__(self, worker_idx: int, actor_id: bytes, addr: str,
                 device: str):
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"train worker {worker_idx}: device "
                                   "'cuda', but this process sees no card")
            torch.cuda.init()  # the context, in the build's seconds
        self.worker_idx = worker_idx
        self._actor_id = actor_id
        self.addr = addr
        self.device = device
        self.state: dict = {}
        self.thread: threading.Thread | None = None
        self._spans: list = []
        self._spans_lock = threading.Lock()

    # ---- calls from the driver ----

    def execute(self, fn: Callable, *args, **kwargs):
        """``fn(self, *args, **kwargs)``, and the spans recorded here since
        the last reply."""
        out = fn(self, *args, **kwargs)
        with self._spans_lock:
            spans, self._spans = self._spans, []
        return out, spans

    def ping(self) -> int:
        return os.getpid()

    def node_id(self) -> str:
        return socket.gethostname()

    def join_count(self, group_name: str) -> int:
        return collective.join_count(group_name)

    def collective_epoch(self, group_name: str) -> int:
        return collective.collective_epoch(group_name)

    def join(self, world_size: int, rank: int, group_name: str,
             addresses: list, authkey: bytes, epoch: int, timeout: float,
             reform: bool) -> int:
        """Join the gang's group at ``epoch`` (a reform when ``reform``)."""
        if reform:
            collective.reform_group(world_size, rank, group_name,
                                    addresses=addresses, authkey=authkey,
                                    epoch=epoch, timeout=timeout)
        else:
            collective.init_collective_group(
                world_size, rank, group_name=group_name, timeout=timeout,
                addresses=addresses, authkey=authkey, epoch=epoch)
        return rank

    def abort_join(self, group_name: str, epoch: int, reason: str) -> None:
        collective.abort_join(group_name, epoch, reason)

    def destroy(self, group_name: str) -> None:
        collective.destroy_collective_group(group_name)

    # ---- the worker's side ----

    def check(self) -> None:
        """A worker that runs is alive: its death ends its process."""

    def exit(self, code: int = 1) -> None:
        """The ``exit`` fault action: this process ends, here."""
        os._exit(code)

    def start_thread(self, target) -> threading.Thread:
        self.thread = threading.Thread(target=target, daemon=True,
                                       name=f"train-loop-{self.worker_idx}")
        self.thread.start()
        return self.thread

    @contextlib.contextmanager
    def stream_context(self):
        """The loop on this process's default stream; what it enqueued is
        done when the block exits."""
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()

    def record(self, cat, name, t0, t1, attrs=None) -> None:
        with self._spans_lock:
            self._spans.append((cat, name, t0, t1, attrs))

    def abort_collectives(self, reason: str = "") -> int:
        """Abort every incarnation and join of this process, here only."""
        return collective.abort_all_local(reason)

    def allreduce(self, tensor, group_name: str, op: str = "sum", *,
                  codec=None, transport=None, timeout: float | None = None,
                  ef_tag: str | None = None, out=None):
        """As :meth:`TrainWorker.allreduce`, over this process's socket
        group: the ranks send to each other, not through the driver."""
        g = collective.get_group(group_name)
        fault_injection.fire("collective.allreduce", group=group_name,
                             rank=g.rank, bucket=ef_tag)
        return collective.allreduce(g, tensor, op, codec=codec,
                                    transport=transport, timeout=timeout,
                                    ef_tag=ef_tag, out=out)


class ProcessWorker:
    """The driver's handle of a train worker process: its identity
    (``worker_idx``, ``_actor_id``), its process (``member``, ``pid``)
    and the runtime restarts of its place."""

    def __init__(self, worker_idx: int, actor_id: bytes, member):
        self.worker_idx = worker_idx
        self._actor_id = actor_id
        self.member = member
        self.restarts = 0
        self.restarting: threading.Event | None = None
        self.retired = False  # reaped by the gang: no runtime restart

    @property
    def pid(self) -> int:
        return self.member.pid

    def __repr__(self):
        return f"ProcessWorker({self.worker_idx}, pid={self.pid})"


class ProcessWorkerGroup:
    """``num_workers`` train workers, each a process of its own (module
    docstring), spawned at once through a ``ProcessRuntime`` of the
    gang's. JAX's ``WorkerGroup`` methods over them: ``max_restarts``
    bounds the respawns :meth:`heal` makes (a fresh process and identity
    in a dead one's place); with ``runtime_restarts`` it is also each
    place's restart of its process in place (JAX's actor
    ``max_restarts``): same identity, empty state. The collective is a
    socket group; the driver picks each epoch (max of the members' live
    epochs and its own last one, plus one) and hands out fresh addresses
    for it, and a member's death during a join aborts the others' joins.
    A worker on ``device="cuda"`` raises without a card; a worker that
    fails to spawn or to build raises."""

    actor_error = ActorError
    processes = True

    def __init__(self, num_workers: int, *, max_restarts: int = 0,
                 runtime_restarts: bool = False, recorder=None,
                 addr: str = "127.0.0.1", device: str = "cuda",
                 name: str = "train"):
        self.recorder = recorder or InertRecorder()
        self._name = name
        self.num_workers = num_workers
        self.max_restarts = max_restarts
        self._respawns_left = max_restarts
        self.runtime_restarts = runtime_restarts
        self._addr = addr
        self._device = device
        self._bundle_count = num_workers
        self._next_worker_idx = 0
        self._coll_group: str | None = None
        self._epoch = 0  # the last epoch this driver handed out
        self._token = uuid.uuid4().hex[:8]
        self._closing = False
        self._rt = ProcessRuntime(on_death=self._on_death)
        self.workers: list[ProcessWorker] = []
        try:
            spawned = self._spawn_many(num_workers)
            errors = [w for w in spawned if isinstance(w, BaseException)]
            if errors:
                raise errors[0]
        except BaseException:
            self._closing = True
            self._rt.shutdown()
            raise
        self.workers = spawned
        self.collective_ranks = list(range(num_workers))

    # ---- members ----

    def _spawn_member(self, idx: int, actor_id: bytes):
        return self._rt.spawn(
            ProcessTrainWorker, {"worker_idx": idx, "actor_id": actor_id,
                                 "addr": self._addr, "device": self._device},
            name=f"{self._name}-{idx}", max_concurrency=MEMBER_CONCURRENCY)

    def _spawn_many(self, n: int) -> list:
        """``n`` workers of fresh identities, spawned at once: each a
        :class:`ProcessWorker`, or the exception its spawn raised."""
        ids = []
        for _ in range(n):
            idx = self._next_worker_idx
            self._next_worker_idx += 1
            ids.append((idx, f"{self._name}-{idx}".encode()))
        out: list = [None] * n

        def one(i):
            try:
                out[i] = ProcessWorker(*ids[i], self._spawn_member(*ids[i]))
            except BaseException as e:  # noqa: BLE001 — the caller decides
                out[i] = e

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def _on_death(self, member) -> None:
        """A worker's process was reaped (the process runtime's reader):
        record it, and restart the place in place while it has runtime
        restarts."""
        w = next((w for w in self.workers if w.member is member), None)
        if w is None or self._closing or w.retired:
            return
        now = time.monotonic()
        self.record("runtime", "worker.killed", now, now,
                    {"member": w.worker_idx, "pid": member.pid,
                     "exitcode": member.process.exitcode})
        if self.runtime_restarts and w.restarts < self.max_restarts:
            w.restarts += 1
            w.restarting = threading.Event()
            threading.Thread(target=self._restart, args=(w, w.restarting),
                             name=f"{self._name}-restart-{w.worker_idx}",
                             daemon=True).start()

    def _restart(self, w: ProcessWorker, done: threading.Event) -> None:
        try:
            member = self._spawn_member(w.worker_idx, w._actor_id)
            if w.retired or self._closing:
                self._rt.kill(member)
            else:
                w.member = member
        except Exception:  # noqa: BLE001 — the place stays dead
            logger.exception("runtime restart of train worker %d failed",
                             w.worker_idx)
        finally:
            w.restarting = None
            done.set()

    def kill(self, w: ProcessWorker) -> None:
        """SIGKILL the worker's process (restarted in place while it has
        runtime restarts)."""
        self._rt.kill(w.member)

    # ---- calls ----

    def _call(self, w: ProcessWorker, method: str, *args):
        return self._rt.call(w.member, method, *args)

    def submit(self, w: ProcessWorker, fn: Callable, *args, **kwargs):
        """Run ``fn(worker, *args, **kwargs)`` in ``w``'s process; a future
        of its result (the spans that came with it go to the recorder)."""
        inner = self._rt.call(w.member, "execute", fn, *args, **kwargs)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut.worker = w

        def settle(f):
            exc = f.exception()
            if exc is not None:
                fut.set_exception(exc)
                return
            out, spans = f.result()
            for span in spans:
                self.record(*span)
            fut.set_result(out)

        inner.add_done_callback(settle)
        return fut

    def get(self, refs, timeout: float | None = None):
        """The result of a future (or a list of them, under one deadline);
        raises :class:`ActorError` for a worker whose process died under
        the call, ``TimeoutError`` past ``timeout``."""
        if isinstance(refs, list):
            deadline = None if timeout is None else time.monotonic() + timeout
            return [self.get(r, None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                    for r in refs]
        try:
            return refs.result(timeout)
        except concurrent.futures.TimeoutError:
            who = getattr(refs, "worker", None)
            raise TimeoutError(
                f"call on worker {getattr(who, 'worker_idx', '?')} outlived "
                f"{timeout} s") from None

    def execute_async(self, fn, *args, **kwargs) -> list:
        return [self.submit(w, fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn, *args, timeout: float = 600.0, **kwargs) -> list:
        return self.get(self.execute_async(fn, *args, **kwargs), timeout)

    def execute_single(self, idx: int, fn, *args, **kwargs):
        return self.get(self.submit(self.workers[idx], fn, *args, **kwargs), 600)

    def node_ids(self) -> list[str]:
        return self.get([self._call(w, "node_id") for w in self.workers], 60)

    def record(self, cat, name, t0, t1, attrs=None) -> None:
        self.recorder.record(cat, name, t0, t1, attrs)

    # ---- elastic membership (JAX's WorkerGroup.probe / heal / grow) ----

    def probe(self, timeout: float = 5.0, indices: list[int] | None = None
              ) -> list[bool]:
        """Liveness of members under one shared deadline: every ping is
        sent at once. A member being restarted is not alive."""
        idxs = range(len(self.workers)) if indices is None else indices
        refs = [self._call(self.workers[i], "ping") for i in idxs]
        deadline = time.monotonic() + timeout
        alive = []
        for ref in refs:
            try:
                ref.result(max(0.1, deadline - time.monotonic()))
                alive.append(True)
            except Exception:  # noqa: BLE001 — dead, or not back yet
                alive.append(False)
        return alive

    def heal(self, *, wait_restart_s: float = 60.0, respawn: bool = True) -> int:
        """JAX's heal: wait (up to ``wait_restart_s``) for runtime
        restarts under way, reap what is still dead, respawn fresh
        workers there at once while the respawn budget lasts, drop the
        rest (shrink). Returns the world size; follow with
        :meth:`reform_collective`."""
        deadline = time.monotonic() + wait_restart_s
        dead = [i for i, ok in enumerate(self.probe()) if not ok]
        while dead and time.monotonic() < deadline:
            pending = [self.workers[i].restarting for i in dead]
            pending = [e for e in pending if e is not None]
            if not pending:
                break
            for e in pending:
                e.wait(max(0.0, deadline - time.monotonic()))
            ok = self.probe(timeout=5.0, indices=dead)
            dead = [i for i, alive in zip(dead, ok) if not alive]
        for i in dead:  # reaped first: no restart may land after this
            w = self.workers[i]
            w.retired = True
            self._rt.kill(w.member)
        picks = dead[:self._respawns_left] if respawn else []
        for i, w in zip(picks, self._spawn_many(len(picks))):
            if isinstance(w, BaseException):
                logger.warning("respawn of train worker %d failed: %s", i, w)
                continue
            self._respawns_left -= 1
            self.workers[i] = w
            dead.remove(i)
            logger.info("train worker %d respawned (%d respawns left)", i,
                        self._respawns_left)
        if dead:
            gone = set(dead)
            self.workers = [w for i, w in enumerate(self.workers)
                            if i not in gone]
            logger.warning("worker group shrunk: dropped dead ranks %s, world "
                           "size now %d", sorted(gone), len(self.workers))
        self.num_workers = len(self.workers)
        if self.num_workers == 0:
            raise RuntimeError("worker group lost every member")
        return self.num_workers

    def grow(self, num_workers: int, timeout: float = 60.0) -> int:
        """Add fresh workers (spawned at once) up to ``num_workers``, at
        most the size the gang started with; a failed spawn stops the
        expansion there. Follow with :meth:`reform_collective`."""
        if num_workers > self._bundle_count:
            raise ValueError(f"cannot grow to {num_workers}: the gang started "
                             f"with {self._bundle_count}")
        for w in self._spawn_many(max(0, num_workers - len(self.workers))):
            if isinstance(w, BaseException):
                logger.warning("grow: a train worker failed to start (%s); "
                               "stopping expansion", w)
                break
            self.workers.append(w)
        self.num_workers = len(self.workers)
        return self.num_workers

    # ---- the collective ----

    def _join_all(self, name: str, epoch: int, reform: bool,
                  timeout: float) -> None:
        """Every member joins ``name`` at ``epoch`` over fresh addresses.
        A member that dies (or fails) during the join ends the others'
        joins at once, through a second call thread of theirs; the
        survivors' ``CollectiveAbortError`` is raised here."""
        world = len(self.workers)
        addresses = collective.socket_addresses(
            self._rt._root, f"{self._token}e{epoch}", world)
        authkey = os.urandom(16)
        refs = [self._call(w, "join", world, r, name, addresses, authkey,
                           epoch, timeout, reform)
                for r, w in enumerate(self.workers)]
        deadline = time.monotonic() + timeout + 30.0
        errors: dict[int, BaseException] = {}
        pending = set(range(world))
        aborted = False
        while pending:
            concurrent.futures.wait([refs[r] for r in pending],
                                    timeout=JOIN_POLL_S,
                                    return_when=concurrent.futures.FIRST_COMPLETED)
            for r in [r for r in pending if refs[r].done()]:
                pending.discard(r)
                if refs[r].exception() is not None:
                    errors[r] = refs[r].exception()
            if errors and pending and not aborted:
                aborted = True
                reason = (f"rank(s) {sorted(errors)} failed during the join "
                          f"of epoch {epoch}: {next(iter(errors.values()))}")
                for r in pending:
                    self._call(self.workers[r], "abort_join", name, epoch,
                               reason)
            if time.monotonic() > deadline:
                raise TimeoutError(f"collective group '{name}': the join of "
                                   f"epoch {epoch} outlived {timeout} s")
        if errors:
            typed = [e for _, e in sorted(errors.items())
                     if isinstance(e, CollectiveAbortError)]
            raise (typed or [errors[min(errors)]])[0]

    def init_collective(self, group_name: str | None = None,
                        backend: str = "cpu", timeout: float = 120.0,
                        **_) -> str:
        """The members join a socket group under JAX's first epoch: one
        past the most times any member has joined the name."""
        name = group_name or f"{self._name}-{self._token}"
        counts = self.get([self._call(w, "join_count", name)
                           for w in self.workers], 60)
        epoch = max([self._epoch] + counts) + 1
        self._epoch = epoch
        self._join_all(name, epoch, False, timeout)
        self._coll_group = name
        self.collective_ranks = list(range(len(self.workers)))
        return name

    def reform_collective(self, group_name: str | None = None,
                          timeout: float = 120.0, **_) -> str:
        """JAX's driver-coordinated reform: the epoch is one past the
        highest of this driver's last and the members' live epochs, and
        every current member re-joins under it (the old incarnation's
        frames dropped, its residuals purged)."""
        name = group_name or self._coll_group
        if not name:
            raise RuntimeError("no collective group to reform")
        refs = [self._call(w, "collective_epoch", name) for w in self.workers]
        deadline = time.monotonic() + EPOCH_QUERY_S
        live = []
        for ref in refs:
            try:
                live.append(ref.result(max(0.1, deadline - time.monotonic())))
            except Exception:  # noqa: BLE001 — this driver's epoch bumps past it
                pass
        epoch = max([self._epoch] + live) + 1
        self._epoch = epoch
        self._join_all(name, epoch, True, timeout)
        self._coll_group = name
        self.collective_ranks = list(range(len(self.workers)))
        return name

    def destroy_collective(self) -> None:
        if not self._coll_group:
            return
        try:
            self.get([self._call(w, "destroy", self._coll_group)
                      for w in self.workers], 30)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        self._coll_group = None

    def shutdown(self) -> list:
        """Kill and reap every worker process and remove the runtime's
        store, socket files included; returns [] (no loop outlives its
        process)."""
        self._closing = True
        self._rt.shutdown()
        self.workers = []
        self._coll_group = None
        return []


class ProcessTrainRuntime:
    """Makes :class:`ProcessWorkerGroup` gangs: each train worker a
    process of its own, with its own CUDA context on ``device="cuda"``
    (the default; CPU callers pass ``device="cpu"``). Opt-in
    (``Trainer(runtime=ProcessTrainRuntime())``); ``recorder`` takes the
    spans (the workers' come back with their replies), and
    ``runtime_restarts`` is as :class:`InProcessTrainRuntime`'s."""

    processes = True
    errors = (ActorError,)

    def __init__(self, recorder=None, *, runtime_restarts: bool = False,
                 addr: str = "127.0.0.1", device: str = "cuda"):
        self.recorder = recorder or InertRecorder()
        self.runtime_restarts = runtime_restarts
        self.addr = addr
        self.device = device

    def worker_group(self, num_workers: int, *, resources_per_worker=None,
                     strategy: str = "SPREAD", max_restarts: int = 0
                     ) -> ProcessWorkerGroup:
        """Processes on this host: ``resources_per_worker`` and
        ``strategy`` are ignored."""
        return ProcessWorkerGroup(num_workers, max_restarts=max_restarts,
                                  runtime_restarts=self.runtime_restarts,
                                  recorder=self.recorder, addr=self.addr,
                                  device=self.device)

    def record(self, cat, name, t0, t1, attrs=None) -> None:
        self.recorder.record(cat, name, t0, t1, attrs)
