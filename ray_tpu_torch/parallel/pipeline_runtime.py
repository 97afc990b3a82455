"""How the MPMD pipeline reaches its workers, and the in-process runtime.

The JAX pipeline (ray_tpu/parallel/mpmd_pipeline.py) runs each (stage,
dp replica) as an actor of a ``WorkerGroup`` gang and reaches it through
the ray_tpu runtime: a p2p collective group over every worker
(``paced_send`` / ``paced_recv``), a gradient allreduce per stage
(``dcn_allreduce_grads``), the train session (``report``,
``get_checkpoint``, ``get_resume_seq``), quiesce, heal and reform under a
new epoch, the ``pipeline.stage`` fault site and the flight recorder.
The port imports nothing of that runtime, so ``MpmdPipeline`` takes
those calls from a runtime passed to it, as ``LLMPool`` takes its
members' calls from ``serve/runtime.py``. A runtime has, for the driver:

- ``start(sizes, name, *, max_restarts, resources)``: one worker per
  (stage s, dp index i < sizes[s]), with ``resources`` each where the
  runtime places workers (the in-process runtime ignores them), global
  rank ``offs[s] + i`` (offs: the cumsum of the sizes) in a p2p group
  over all of them, and a sum group per stage; epoch 1;
- ``workers() -> [(stage, index, handle)]``, in global-rank order;
- ``launch(handle, fn, config, resume_path, resume_seq)``: run
  ``fn(session, config)`` on the worker, ``session`` being the worker's
  side of the runtime (below);
- ``results(timeout) -> [(handle, result)]``: the results the workers of
  the current launch gave since the last call, waiting up to
  ``timeout`` for the first: ``{"type": "report", "metrics": ...}``,
  ``{"type": "finished"}`` or ``{"type": "error", "error_type",
  "error", "error_path"}``; a worker that died gives an error of type
  ``WorkerDiedError``;
- ``quiesce(timeout) -> [(stage, index)]``: abort every collective, end
  every loop, and return the workers whose loop did not end in time;
- ``alive(handle)``; ``respawn(handle)``: a fresh worker in a dead one's
  place (raises past ``max_restarts`` respawns of one place);
- ``reform() -> epoch``: new p2p lanes and sum groups under the next
  epoch;
- ``kill(handle)``: the worker dies at its next runtime call;
- ``record(cat, name, t0, t1, attrs)``: a span; ``shutdown()``.

And for a worker, its session: ``stage``, ``dp_rank``, ``rank``,
``resume_seq``, ``checkpoint`` (a ``Checkpoint`` to resume from, or
None), ``send(x, dst)`` and ``recv(src, timeout)`` on the p2p lanes,
``allreduce_sum(tree, timeout)`` over the stage's replicas,
``report(metrics)``, ``arm(fault_specs)`` and ``fire(site, **ctx)``
(the fault site: ``die``
raises :class:`InjectedFault`, ``exit`` kills the worker, ``drop`` is
returned for the caller to act on) and
``record(...)``.

:class:`InProcessPipelineRuntime` is the default: each worker is a thread
of this process (with a CUDA stream of its own when there is a card), a
p2p lane is a FIFO of host arrays per (sender, receiver) pair, and the
stage sum adds the replicas' trees in dp-rank order. Its kill, abort,
quiesce, respawn, reform and worker streams are the train gang's
(``train/worker_group.py`` ``InProcessGang``), its fault specs' rule
``train/fault_injection.py``'s.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train import fault_injection
from ray_tpu_torch.train.fault_injection import InjectedFault
from ray_tpu_torch.train.worker_group import (  # noqa: F401
    POLL_S,
    CollectiveAbortError,
    CollectiveTimeoutError,
    Epoch,
    InertRecorder,
    InProcessGang,
    Member,
    WorkerKilled,
)
from ray_tpu_torch.utils.trees import tree_map


class Reduce:
    """The values of n members combined in member order (``combine`` of
    the list); every member gets the same result, which it must not
    write to."""

    def __init__(self, n: int, combine: Callable[[list], Any]):
        self.n = n
        self.combine = combine
        self.cond = threading.Condition()
        self.slots: list = [None] * n
        self.arrived = 0
        self.generation = 0
        self.last = None

    def __call__(self, index, value, check, deadline):
        with self.cond:
            gen = self.generation
            self.slots[index] = value
            self.arrived += 1
            if self.arrived == self.n:
                self.last = self.combine(self.slots)
                self.slots, self.arrived = [None] * self.n, 0
                self.generation += 1
                self.cond.notify_all()
            while self.generation == gen:
                check()
                if time.monotonic() > deadline:
                    raise CollectiveTimeoutError(
                        f"reduce: {self.arrived} of {self.n} members")
                self.cond.wait(POLL_S)
            return self.last


def _tree_sum(trees: list):
    total = trees[0]
    for t in trees[1:]:
        total = tree_map(lambda a, b: a + b, total, t)
    return total


class _Group(Epoch):
    """One epoch's collectives: the p2p lanes and each stage's sum (the
    trees of its replicas summed in dp-rank order)."""

    def __init__(self, epoch: int, sizes: list[int]):
        super().__init__(epoch)
        self.lanes: dict[tuple[int, int], queue.Queue] = {}
        self.sums = [Reduce(n, _tree_sum) for n in sizes]
        self.bytes_sent = 0

    def lane(self, src: int, dst: int) -> queue.Queue:
        with self.lock:
            return self.lanes.setdefault((src, dst), queue.Queue())


@dataclasses.dataclass(eq=False)
class _Worker(Member):
    """One (stage, dp index) place and its current incarnation."""

    stage: int = 0
    index: int = 0
    rank: int = 0
    launch_id: int = 0
    session: "_Session | None" = None


class _Session:
    """A worker's side of the in-process runtime, for one launch."""

    def __init__(self, rt, worker: _Worker, group: _Group, resume_path,
                 resume_seq: int):
        self._rt, self._worker, self._group = rt, worker, group
        self.stage, self.dp_rank, self.rank = worker.stage, worker.index, worker.rank
        self.resume_seq = resume_seq
        self.checkpoint = Checkpoint(resume_path) if resume_path else None
        self._specs: list[dict] = []

    def arm(self, fault_specs) -> None:
        """Arm fault specs (``train/fault_injection.py``'s dicts: ``site``,
        ``match``, ``after``, ``count``, ``action``: die, exit or drop) for
        this worker's ``fire`` calls."""
        self._specs = fault_injection.prepare(fault_specs)

    def _check(self):
        self._rt.check(self._worker, self._group)

    def send(self, x, dst: int) -> None:
        self._check()
        arr = np.array(x, copy=True)
        with self._group.lock:
            self._group.bytes_sent += arr.nbytes
        self._group.lane(self.rank, dst).put(arr)

    def recv(self, src: int, timeout: float):
        lane = self._group.lane(src, self.rank)
        deadline = time.monotonic() + timeout
        while True:
            self._check()
            try:
                return lane.get(timeout=POLL_S)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise CollectiveTimeoutError(
                        f"rank {self.rank}: nothing from rank {src} in "
                        f"{timeout} s") from None

    def allreduce_sum(self, tree, timeout: float):
        self._check()
        return self._group.sums[self.stage](
            self.dp_rank, tree, self._check, time.monotonic() + timeout)

    def report(self, metrics: dict) -> None:
        self._check()
        self._rt._post(self._worker, {"type": "report", "metrics": metrics})

    def fire(self, site: str, **ctx):
        self._check()
        for spec in self._specs:
            if not fault_injection.matches(spec, site, ctx):
                continue
            action = spec["action"]
            if action == "die":
                raise InjectedFault(site, ctx)
            if action == "exit":
                self._rt.kill(self._worker)
                raise WorkerKilled()
            return action  # "drop": the caller skips the send
        return None

    def record(self, cat, name, t0, t1, attrs=None):
        self._rt.record(cat, name, t0, t1, attrs)


class InProcessPipelineRuntime(InProcessGang):
    """Workers are threads of this process (module docstring), on the
    kill, abort, quiesce, respawn and reform logic of
    ``train/worker_group.py``'s ``InProcessGang``. ``recorder`` takes the
    spans (an object with ``record(cat, name, t0, t1, attrs)``; inert when
    None). ``bytes_sent`` counts the bytes put on the p2p lanes since
    ``start``."""

    def __init__(self, recorder=None):
        super().__init__(recorder)
        self._workers: list[_Worker] = []
        self._sizes: list[int] = []
        self._results: queue.Queue = queue.Queue()
        self._bytes_before = 0

    @property
    def _members(self):
        return self._workers

    @property
    def _group(self) -> _Group | None:
        return self._epoch

    def _new_epoch(self, epoch: int) -> _Group:
        return _Group(epoch, self._sizes)

    @property
    def bytes_sent(self) -> int:
        return self._bytes_before + (self._group.bytes_sent if self._group else 0)

    def start(self, sizes, name: str, *, max_restarts: int = 0,
              resources: dict | None = None) -> None:
        """Workers are threads here: ``resources`` is ignored."""
        self._sizes, self._name = list(sizes), name
        self._max_restarts = max_restarts
        self._bytes_before = 0
        offs = np.cumsum([0] + self._sizes[:-1])
        self._workers = [_Worker(stage=s, index=i, rank=int(offs[s]) + i)
                         for s, n in enumerate(self._sizes) for i in range(n)]
        self._epoch = self._new_epoch(1)

    def workers(self) -> list:
        return [(w.stage, w.index, w) for w in self._workers]

    def launch(self, handle: _Worker, fn, config: dict, resume_path,
               resume_seq: int) -> None:
        if handle.dead:
            raise RuntimeError(f"{self._name}: worker {handle.stage}/"
                               f"{handle.index} is dead")
        if handle.thread is not None and handle.thread.is_alive():
            raise RuntimeError(f"{self._name}: worker {handle.stage}/"
                               f"{handle.index} is still running")
        handle.launch_id += 1
        handle.session = _Session(self, handle, self._group, resume_path,
                                  resume_seq)
        handle.thread = self.spawn_thread(
            handle, self._run, (handle, handle.launch_id, fn, config),
            name=f"{self._name}-stage{handle.stage}-{handle.index}")

    def _run(self, handle: _Worker, launch_id: int, fn, config):
        try:
            with self.on_stream(handle):  # done before the result is posted
                fn(handle.session, config)
        except WorkerKilled:
            result = {"type": "error", "error_type": "WorkerDiedError",
                      "error": f"worker {handle.stage}/{handle.index} died",
                      "error_path": ""}
        except Exception as e:  # noqa: BLE001 — reported to the driver
            result = {"type": "error", "error_type": type(e).__name__,
                      "error": traceback.format_exc(),
                      "error_path": str(getattr(e, "path", "") or "")}
        else:
            result = {"type": "finished"}
        self._results.put((handle, launch_id, result))

    def _post(self, handle: _Worker, result: dict) -> None:
        self._results.put((handle, handle.launch_id, result))

    def results(self, timeout: float) -> list:
        out = []
        try:
            item = self._results.get(timeout=timeout)
            while True:
                handle, launch_id, result = item
                if launch_id == handle.launch_id:
                    out.append((handle, result))
                item = self._results.get_nowait()
        except queue.Empty:
            return out

    def quiesce(self, timeout: float) -> list:
        return [(w.stage, w.index) for w in super().quiesce(timeout)]

    def reform(self) -> int:
        self._bytes_before += self._group.bytes_sent
        return super().reform()

    def shutdown(self, timeout: float = 10.0) -> list:
        """Abort and join every worker; returns those still running."""
        stuck = self.quiesce(timeout) if self._workers else []
        self._workers = []
        return stuck
