"""Gang lifecycle for distributed training.

The port's counterpart of ray_tpu/train/backend_executor.py, over a gang
from an injected runtime (``train/worker_group.py``; the in-process
``InProcessTrainRuntime`` by default). Two backends:

- ``backend="dcn"``, as in JAX: every worker trains alone on its device
  and syncs gradients through the gang's collective
  (``train.dcn_allreduce_grads``). No group spans the workers, so a dead
  rank is survivable in place: :meth:`BackendExecutor.heal_inplace`
  quiesces the survivors, heals the gang (respawn or shrink, then re-grow
  toward the target), reforms the collective under a new epoch,
  rebalances the dataset shards, and :meth:`start_training` warm-restarts
  the loops; survivors keep their threads' device state and their shard
  cursors.
- ``backend="torch"``, in place of JAX's ``"jax"``: one
  ``torch.distributed`` process group spans the workers (NCCL on cuda,
  gloo on cpu), its TCP rendezvous on a port picked on worker 0 at the
  host address the runtime gives it (JAX's ``_pick_coordinator``). A
  broken group cannot be reformed, so a failure restarts the whole gang.
  It needs a process per worker: a runtime without (the in-process one)
  runs it at world size 1 only. NCCL needs a card per rank: two ranks on
  one card are not supported, and ``_setup_backend`` raises for them
  (gloo on the CPU runs any world on the process gang).

The functions below are module-level, so a worker process unpickles them
by reference; a worker in a process gives its spans back with the reply
of each call (``train/worker_group.py``).

JAX's ``_config_local_jax`` (the jax platform and virtual device flags
of a fresh actor process) has no counterpart: the device is the loop's
own choice.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import traceback
from typing import Any, Callable

from ray_tpu_torch.train import session as S
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.worker_group import InProcessTrainRuntime

logger = logging.getLogger(__name__)

# the runtime-config defaults of the JAX package this module reads
QUIESCE_TIMEOUT_S = 30.0       # train_quiesce_timeout_s
REFORM_TIMEOUT_S = 120.0       # collective_reform_timeout_s


# ---- functions run on the workers (their first argument the worker) ----


def _pick_coordinator(worker) -> str:
    """On worker 0: a free port on its host for the process group."""
    import socket

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return f"{worker.addr}:{port}"


def _setup_backend(worker, coordinator: str, world_size: int, device: str):
    """Join the process group (rank = worker_idx): NCCL on cuda, gloo on
    cpu. At world size 1 in a process that already has a default group
    (the in-process runtime), that group is kept."""
    import torch.distributed as dist

    if world_size == 1 and dist.is_initialized():
        worker.state["world_size"] = 1
        return {"rank": 0, "world_size": 1}
    backend = "nccl" if device == "cuda" else "gloo"
    if backend == "nccl":
        import torch

        if torch.cuda.device_count() < world_size:
            raise RuntimeError(
                f"backend 'torch' on cuda: NCCL needs a card per rank, and "
                f"this host has {torch.cuda.device_count()} for world size "
                f"{world_size} (two ranks on one card are not supported)")
        torch.cuda.set_device(worker.worker_idx)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=worker.worker_idx, world_size=world_size)
    worker.state["world_size"] = world_size
    worker.state["owns_process_group"] = True
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size()}


def _teardown_backend(worker):
    import torch.distributed as dist

    if worker.state.pop("owns_process_group", False) and dist.is_initialized():
        dist.destroy_process_group()


def _setup_backend_local(worker, world_size: int):
    """dcn backend: no group spans the workers (their sync rides the
    gang's collective), which is what makes a membership change
    survivable in place."""
    import os

    worker.state["world_size"] = world_size
    return {"pid": os.getpid()}


def _start_training(worker, fn: Callable, config: dict,
                    resume_ckpt_path: str | None, rank: int | None = None,
                    world_size: int | None = None,
                    collective_group: str | None = None,
                    shard_plan: dict | None = None, resume_seq: int = 0):
    """Start the user loop on a thread of the worker. ``rank`` and
    ``world_size`` default to the worker's identity (cold start); a warm
    resume passes the post-heal gang position. ``shard_plan`` maps a
    dataset name to (blocks, assigned indices), blocks None for a worker
    that already holds them: existing shards are reassigned (cursor
    kept), not rebuilt."""
    from ray_tpu_torch.train import fault_injection

    if rank is None:
        rank = worker.worker_idx
    if world_size is None:
        world_size = worker.state.get("world_size", 1)
    shards = worker.state.setdefault("dataset_shards", {})
    for name, (blocks, indices) in (shard_plan or {}).items():
        sh = shards.get(name)
        if sh is None:
            if blocks is None:
                raise RuntimeError(f"dataset {name!r}: no blocks shipped to a "
                                   "worker with no existing shard")
            shards[name] = S.DataShard(name, blocks, indices)
        else:
            sh.reassign(indices, blocks=blocks)
    if resume_seq and resume_ckpt_path is None:
        # a warm resume with no checkpoint restarts the model from
        # scratch: the cursors restart with it
        for sh in shards.values():
            sh.load_state({"epoch": 0, "consumed": []})
    sess = S._init_session(
        world_rank=rank, world_size=world_size,
        resume_checkpoint=Checkpoint(resume_ckpt_path) if resume_ckpt_path else None,
        collective_group=collective_group, resume_seq=resume_seq,
        dataset_shards=shards, worker=worker)
    worker.state["session"] = sess

    def _run():
        S._bind(sess)
        exit_handler = getattr(worker, "exit", None)
        fault_injection.set_exit_handler(exit_handler)
        stream = getattr(worker, "stream_context", contextlib.nullcontext)
        try:
            with stream():  # what the loop enqueued is done on exit
                fn(config or {})
        except BaseException as e:  # noqa: BLE001 — surfaced to the trainer
            # the error keeps its text, not its frames: a frame, even
            # cleared, holds its function, so a closure of the loop that
            # captured the train state would hold the device memory of a
            # dead loop until a collection of the cycle through sess
            sess.error_text = "".join(traceback.format_exception(e))
            _drop_tracebacks(e)
            sess.error = e
        finally:
            sess.finished.set()
            fault_injection.set_exit_handler(None)
            S._bind(None)

    start = getattr(worker, "start_thread", None)
    t = start(_run) if start is not None else threading.Thread(
        target=_run, daemon=True, name="train_loop")
    if start is None:
        t.start()
    worker.state["train_thread"] = t
    return True


def _drop_tracebacks(e: BaseException | None, seen: set | None = None) -> None:
    """Drop the frames of ``e`` and of the errors it chains."""
    seen = set() if seen is None else seen
    if e is None or id(e) in seen:
        return
    seen.add(id(e))
    e.__traceback__ = None
    _drop_tracebacks(e.__cause__, seen)
    _drop_tracebacks(e.__context__, seen)


def _next_result(worker, timeout: float = 10.0):
    """One report from the worker's session queue, else its end."""
    import queue as _q

    sess = worker.state["session"]
    deadline = time.monotonic() + timeout
    while True:
        try:
            item = sess.results.get(timeout=0.1)
            return {"type": "report", **item}
        except _q.Empty:
            if sess.finished.is_set() and sess.results.empty():
                if sess.error is not None:
                    return {"type": "error", "error": sess.error_text,
                            "error_type": type(sess.error).__name__,
                            "error_path": str(getattr(sess.error, "path", "")
                                              or "")}
                return {"type": "finished"}
            if time.monotonic() > deadline:
                return {"type": "pending"}


def _state_empty(worker):
    """True when the worker never ran a backend setup: a worker the
    runtime restarted (same identity, empty state)."""
    return "world_size" not in worker.state


def _quiesce(worker, timeout: float):
    """Unwind this survivor's loop before a warm resume: abort its
    collectives (waking blocked calls), drain unconsumed reports, and
    wait for the loop thread. ``ok=False``: the survivor is wedged in
    user code, and the trainer falls back to a gang restart."""
    import os
    import queue as _q

    sess = worker.state.get("session")
    t = worker.state.get("train_thread")
    if sess is None and t is None:
        return {"ok": True, "fresh": True, "pid": os.getpid()}
    worker.abort_collectives("in-place resume: quiescing survivors")
    deadline = time.monotonic() + timeout
    done = False
    while True:
        if sess is not None:
            while True:  # drain report backpressure
                try:
                    sess.results.get_nowait()
                except _q.Empty:
                    break
        done = sess.finished.wait(0.2) if sess is not None else True
        if done or time.monotonic() > deadline:
            break
    if t is not None and done:
        t.join(timeout=max(1.0, deadline - time.monotonic()))
    alive = bool(t is not None and t.is_alive())
    etype = None
    if sess is not None and sess.error is not None:
        etype = type(sess.error).__name__
    return {"ok": bool(done and not alive), "pid": os.getpid(),
            "error_type": etype}


def _gather_tolerant(wg, refs: list, timeout: float) -> list:
    """Every ref under one shared deadline; a failed one gives its
    exception instead of raising."""
    deadline = time.monotonic() + timeout
    out: list[Any] = []
    for ref in refs:
        try:
            out.append(wg.get(ref, max(0.1, deadline - time.monotonic())))
        except Exception as e:  # noqa: BLE001 — dead or unreachable rank
            out.append(e)
    return out


class TrainingFailedError(RuntimeError):
    """Raised by the trainer's result loop. ``error_type``: the worker
    exception's type name; ``error_path``: the failing checkpoint's path
    (CheckpointCorruptError); ``dead_ranks``: gang positions that died."""

    error_type: str = ""
    error_path: str = ""
    dead_ranks: list[int]

    def __init__(self, *args):
        super().__init__(*args)
        self.dead_ranks = []


class BackendExecutor:
    """Start a worker gang on ``runtime``, wire the backend, stream
    results; the trainer drives restarts and, on the dcn backend, in-place
    resumes. ``device`` is what the torch backend's group runs on."""

    def __init__(self, num_workers: int,
                 resources_per_worker: dict | None = None,
                 strategy: str = "SPREAD",
                 backend: str = "dcn",
                 min_workers: int | None = None,
                 datasets: dict | None = None,
                 max_restarts: int = 0,
                 *, runtime=None, device: str = "cuda",
                 quiesce_timeout_s: float = QUIESCE_TIMEOUT_S):
        if backend not in ("torch", "dcn"):
            raise ValueError(f"backend must be 'torch' or 'dcn', got {backend!r}")
        self.runtime = runtime if runtime is not None else InProcessTrainRuntime()
        if backend == "torch" and num_workers > 1 and not getattr(
                self.runtime, "processes", False):
            raise ValueError(
                f"backend 'torch' needs a process per worker: "
                f"{type(self.runtime).__name__} runs its workers as threads of "
                f"one process, so world size {num_workers} is refused (use "
                "backend='dcn', or a runtime with processes)")
        self.num_workers = num_workers
        self.target_workers = num_workers
        self.min_workers = min_workers if min_workers is not None else num_workers
        self.resources_per_worker = resources_per_worker
        self.strategy = strategy
        self.backend = backend
        self.max_restarts = max_restarts
        self.device = device
        self.quiesce_timeout_s = quiesce_timeout_s
        self.datasets = dict(datasets or {})
        self.worker_group = None
        self.group_name: str | None = None
        self.start_count = 0
        # dataset name -> {actor_id: [block indices]}
        self._assignments: dict[str, dict[bytes, list[int]]] = {}
        # actor ids whose shards already hold the block lists
        self._seeded_ids: set[bytes] = set()
        # actor_id -> in-flight _next_result ref whose fetch timed out
        # while the rank was alive (the report is off its queue already)
        self._result_refs: dict[bytes, Any] = {}

    def start(self):
        self.start_count += 1
        self.worker_group = wg = self.runtime.worker_group(
            self.num_workers, resources_per_worker=self.resources_per_worker,
            strategy=self.strategy, max_restarts=self.max_restarts)
        if self.backend == "dcn":
            infos = wg.execute(_setup_backend_local, self.num_workers,
                               timeout=180.0)
            self.group_name = wg.init_collective()
        else:
            coordinator = wg.execute_single(0, _pick_coordinator)
            infos = wg.execute(_setup_backend, coordinator, self.num_workers,
                               self.device, timeout=180.0)
        self._seed_assignments()
        logger.info("train backend up (%s): %s", self.backend, infos)
        return infos

    # ---- dataset shard assignment (the trainer's record) ----

    def _seed_assignments(self):
        self._assignments = {}
        self._seeded_ids = set()
        workers = self.worker_group.workers
        for name, blocks in self.datasets.items():
            per: dict[bytes, list[int]] = {w._actor_id: [] for w in workers}
            for i in range(len(blocks)):
                per[workers[i % len(workers)]._actor_id].append(i)
            self._assignments[name] = per

    def _rebalance_assignments(self):
        """Re-split after a membership change: survivors keep their
        indices; orphaned indices go to the lightest-loaded workers first
        (ties to members with no prior assignment), then loads are
        levelled, most recently adopted indices moving first."""
        workers = self.worker_group.workers
        for name, per in self._assignments.items():
            n_blocks = len(self.datasets[name])
            keep = {w._actor_id: list(per.get(w._actor_id, [])) for w in workers}
            assigned = set()
            for v in keep.values():
                assigned.update(v)
            for i in [i for i in range(n_blocks) if i not in assigned]:
                tgt = min(range(len(workers)),
                          key=lambda k: (len(keep[workers[k]._actor_id]),
                                         workers[k]._actor_id in per, k))
                keep[workers[tgt]._actor_id].append(i)
            lo = n_blocks // len(workers)
            for taker in [v for v in keep.values() if len(v) < lo]:
                while len(taker) < lo:
                    donor = max(keep.values(), key=len)
                    if len(donor) <= lo:
                        break
                    taker.append(donor.pop())
            self._assignments[name] = keep

    def _shard_plan(self, w) -> dict:
        """One worker's assignments; the block lists ship only on a
        worker's first plan."""
        fresh = w._actor_id not in self._seeded_ids
        return {name: (self.datasets[name] if fresh else None,
                       per.get(w._actor_id, []))
                for name, per in self._assignments.items()}

    # ---- training lifecycle ----

    def start_training(self, train_fn: Callable, config: dict,
                       resume_ckpt_path: str | None = None, *,
                       resume_seq: int = 0):
        # in-flight result refs belong to the previous session's loops
        self._result_refs.clear()
        wg = self.worker_group
        workers = wg.workers
        refs = [wg.submit(w, _start_training, train_fn, config,
                          resume_ckpt_path, r, len(workers), self.group_name,
                          self._shard_plan(w), resume_seq)
                for r, w in enumerate(workers)]
        wg.get(refs, 300)
        self._seeded_ids = {w._actor_id for w in workers}

    def next_results(self, timeout: float = 10.0) -> list[dict]:
        """One lockstep round of per-worker results; a worker that died
        gives ``{"type": "dead"}``. An alive rank's timed-out ref is kept
        and fetched again next round (its report is off its queue)."""
        wg = self.worker_group
        workers = wg.workers
        refs = []
        for w in workers:
            ref = self._result_refs.pop(w._actor_id, None)
            if ref is None:
                ref = wg.submit(w, _next_result, timeout)
            refs.append(ref)
        results = _gather_tolerant(wg, refs, timeout + 60)
        lost = [r for r, res in enumerate(results) if isinstance(res, Exception)]
        if lost:
            alive = wg.probe(timeout=5.0, indices=lost)
            for r, up in zip(lost, alive):
                if up:
                    self._result_refs[workers[r]._actor_id] = refs[r]
                    results[r] = {"type": "pending"}
        return [{"type": "dead", "error": f"{type(r).__name__}: {r}"}
                if isinstance(r, Exception) else r for r in results]

    # ---- in-place elastic resume (dcn backend) ----

    def supports_inplace_resume(self) -> bool:
        return self.backend == "dcn" and self.worker_group is not None

    def heal_inplace(self, *, regrow: bool = True) -> int:
        """Make the gang trainable again without tearing it down:
        quiesce survivors (a wedged one raises: gang fallback), heal
        (respawn or shrink), re-grow toward the target, set up fresh
        members only, reform the collective, rebalance the shards.
        Returns the new world size."""
        if not self.supports_inplace_resume():
            raise RuntimeError(f"in-place resume unsupported: backend="
                               f"{self.backend!r} (a broken process group "
                               "cannot be reformed)")
        wg = self.worker_group
        quiesce_s = float(self.quiesce_timeout_s)
        old_ids = {w._actor_id for w in wg.workers}
        refs = [wg.submit(w, _quiesce, quiesce_s) for w in wg.workers]
        results = _gather_tolerant(wg, refs, quiesce_s + 30)
        wedged = [r for r, res in enumerate(results)
                  if not isinstance(res, Exception) and not res.get("ok")]
        lost = [r for r, res in enumerate(results) if isinstance(res, Exception)]
        if lost:
            alive = wg.probe(timeout=5.0, indices=lost)
            wedged.extend(r for r, up in zip(lost, alive) if up)
        if wedged:
            wedged.sort()
            raise RuntimeError(f"in-place resume: survivor ranks {wedged} still "
                               f"running user code after {quiesce_s}s quiesce")
        world = wg.heal(wait_restart_s=quiesce_s)
        if regrow and world < self.target_workers:
            world = wg.grow(self.target_workers)
        if world < self.min_workers:
            raise RuntimeError(f"in-place resume: world size {world} below the "
                               f"elastic floor min_workers={self.min_workers}")
        fresh = [w for w in wg.workers if w._actor_id not in old_ids]
        # a runtime-restarted worker kept its identity but lost its state:
        # set it up and ship its blocks as a fresh member's
        carried = [w for w in wg.workers if w._actor_id in old_ids]
        if carried:
            empty = wg.get([wg.submit(w, _state_empty) for w in carried], 60)
            reborn = [w for w, e in zip(carried, empty) if e]
            fresh.extend(reborn)
            for w in reborn:
                self._seeded_ids.discard(w._actor_id)
        if fresh:
            wg.get([wg.submit(w, _setup_backend_local, world) for w in fresh], 180)
        wg.reform_collective(timeout=REFORM_TIMEOUT_S)
        self._rebalance_assignments()
        self.num_workers = world
        logger.info("in-place heal complete: world %d (%d fresh member(s), %d "
                    "survivor(s) kept their state)", world, len(fresh),
                    world - len(fresh))
        return world

    def shutdown(self):
        if self.worker_group is not None:
            if self.backend == "torch":
                try:
                    self.worker_group.execute(_teardown_backend, timeout=60.0)
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    pass
            self.worker_group.shutdown()
            self.worker_group = None
