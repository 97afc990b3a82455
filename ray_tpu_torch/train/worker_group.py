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
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Any, Callable

import torch

from ray_tpu_torch.collective import collective, ring
from ray_tpu_torch.collective.collective import (  # noqa: F401 (re-exported)
    CollectiveAbortError,
    CollectiveTimeoutError,
)
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

    def exit(self) -> None:
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
