"""Per-worker training session.

The port's own copy of ray_tpu/train/session.py: the user's train loop
runs on a thread of its worker; ``report(metrics, checkpoint=...)`` hands
results to a queue of one that the trainer drains a step at a time, which
keeps the workers in lockstep at report boundaries. The session also
carries this incarnation's collective group (``get_collective_group``),
the resume counter (``get_resume_seq``) and the rank's dataset shards
(``get_dataset_shard``). :class:`DataShard` objects live in the worker's
state, so a warm resume keeps a survivor's cursor.

One difference from JAX: JAX keeps one session per process, because each
worker is a process. The port's in-process workers are threads of one
process, so the session is bound to the loop thread (a
``threading.local``) and the module functions resolve the calling
worker's session; the worker's own calls (``_next_result``, ``_quiesce``)
take it from the worker's state. A runtime with a process per worker
works the same way. The step breakdown goes to the worker's runtime
(``record``) and to :func:`_step_metrics`, a process-wide tally, in
place of JAX's flight recorder and Prometheus metrics. A worker in a
process of its own keeps its spans (``train.step``,
``train.checkpoint_save``) until the reply of its next call, which
carries them to the driver's recorder (the report's own ``_next_result``
reply carries its step); ``time.monotonic()`` is the system's clock on
Linux, so its stamps compare with the driver's.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any


class DataShard:
    """One rank's slice of a named dataset: an assigned subset of the
    dataset's blocks plus an epoch cursor.

    Iterating yields the not-yet-consumed blocks of the current epoch
    (marking each consumed); draining the assignment bumps the epoch and
    clears the consumed set, so ``for block in shard:`` is one epoch pass.
    :meth:`reassign` installs a rebalanced assignment and keeps the epoch
    and the consumed set for the indices this rank keeps; indices adopted
    from a dead rank start unconsumed (at-least-once delivery)."""

    def __init__(self, name: str, blocks, indices):
        self.name = name
        self._blocks = blocks  # the whole index-addressed block list
        self.indices = list(indices)
        self.epoch = 0
        self._consumed: set[int] = set()

    def __len__(self) -> int:
        return len(self.indices)

    def assigned_indices(self) -> list[int]:
        """The block indices assigned to this rank (the union over ranks
        is the whole dataset, disjoint)."""
        return list(self.indices)

    def state(self) -> dict:
        """The cursor, to checkpoint next to the model state and restore
        with :meth:`load_state`, so a rollback rewinds the data too."""
        return {"epoch": self.epoch, "consumed": sorted(self._consumed)}

    def load_state(self, state: dict) -> None:
        """Restore a cursor from :meth:`state`; consumed entries for
        indices this rank no longer owns are dropped."""
        self.epoch = int(state.get("epoch", 0))
        self._consumed = set(state.get("consumed", ())) & set(self.indices)

    def reassign(self, indices, blocks=None) -> None:
        if blocks is not None:
            self._blocks = blocks
        self._consumed &= set(indices)  # drop the cursor of lost indices
        self.indices = list(indices)

    def __iter__(self):
        # a consumer that broke out on the final block left everything
        # consumed without reaching the boundary below: roll the epoch
        if self.indices and set(self.indices) <= self._consumed:
            self.epoch += 1
            self._consumed.clear()
        for i in list(self.indices):
            if i in self._consumed:
                continue
            self._consumed.add(i)
            t0 = time.monotonic()
            block = self._blocks[i]
            _add_step_time("data", time.monotonic() - t0)
            yield block
        # fully drained: epoch boundary (an empty assignment never bumps)
        if self.indices and set(self.indices) <= self._consumed:
            self.epoch += 1
            self._consumed.clear()


@dataclass
class _Session:
    world_rank: int
    world_size: int
    local_rank: int = 0
    experiment_dir: str | None = None
    resume_checkpoint: Any = None  # Checkpoint | None
    # name of the gang's collective group ("dcn" backend), if any
    collective_group: str | None = None
    # how many resumes (in-place or gang) preceded this incarnation
    resume_seq: int = 0
    # name -> DataShard (owned by the worker's state; survives warm resume)
    dataset_shards: dict = field(default_factory=dict)
    # the worker's side of the runtime: allreduce, record, check (or None)
    worker: Any = None
    # queue(1): report() blocks until the trainer took the previous result
    results: "queue.Queue[Any]" = field(
        default_factory=lambda: queue.Queue(maxsize=1))
    finished: threading.Event = field(default_factory=threading.Event)
    error: BaseException | None = None  # the loop's, without its traceback
    error_text: str = ""  # its formatted traceback
    # report() closes a "train.step" span split into the wait segments
    # added by _add_step_time (collective, data, checkpoint); the rest is
    # compute
    step_t0: float = field(default_factory=time.monotonic)
    step_index: int = 0
    step_segments: dict = field(default_factory=dict)


_local = threading.local()
_metrics_lock = threading.Lock()
_metrics: dict = {"step_s": {}, "seg_s": {}}


def _init_session(**kwargs) -> _Session:
    """A new session; the loop thread binds it with :func:`_bind`."""
    return _Session(**kwargs)


def _bind(sess: _Session | None) -> None:
    """Make ``sess`` the calling thread's session."""
    _local.session = sess


def _current() -> _Session | None:
    return getattr(_local, "session", None)


def _get_session() -> _Session:
    s = _current()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.session used outside a "
                           "training worker")
    return s


def _shutdown_session() -> None:
    _local.session = None


def _step_metrics() -> dict:
    """The process-wide step tally: {"step_s": {rank: [seconds, ...]},
    "seg_s": {(rank, segment): seconds}} (a copy)."""
    with _metrics_lock:
        return {"step_s": {k: list(v) for k, v in _metrics["step_s"].items()},
                "seg_s": dict(_metrics["seg_s"])}


def _add_step_time(segment: str, dt: float) -> None:
    """Add a wait segment to the current step; no-op outside a worker."""
    s = _current()
    if s is None or dt <= 0:
        return
    s.step_segments[segment] = s.step_segments.get(segment, 0.0) + dt


def _record(cat: str, name: str, t0: float, t1: float,
            attrs: dict | None = None) -> None:
    """A span to the calling worker's runtime; no-op outside a worker."""
    s = _current()
    rec = getattr(s.worker, "record", None) if s is not None else None
    if rec is not None:
        rec(cat, name, t0, t1, attrs)


def _close_step(s: _Session, metrics: dict) -> None:
    now = time.monotonic()
    t0, segs = s.step_t0, s.step_segments
    s.step_index += 1
    s.step_segments = {}
    dur = max(0.0, now - t0)
    coll = segs.get("collective", 0.0)
    data = segs.get("data", 0.0)
    ckpt = segs.get("checkpoint", 0.0)
    compute = max(0.0, dur - coll - data - ckpt)
    _record("train", "train.step", t0, now,
            {"rank": s.world_rank, "step": int(metrics.get("step", s.step_index)),
             "resume_seq": s.resume_seq, "collective_wait_s": coll,
             "data_wait_s": data, "checkpoint_s": ckpt, "compute_s": compute})
    with _metrics_lock:
        _metrics["step_s"].setdefault(s.world_rank, []).append(dur)
        for seg, v in (("compute", compute), ("collective", coll),
                       ("data", data), ("checkpoint", ckpt)):
            if v > 0:
                key = (s.world_rank, seg)
                _metrics["seg_s"][key] = _metrics["seg_s"].get(key, 0.0) + v


def _check(s: _Session) -> None:
    check = getattr(s.worker, "check", None)
    if check is not None:
        check()


def report(metrics: dict, checkpoint=None) -> None:
    """Report metrics (and optionally a checkpoint) to the trainer; blocks
    until the trainer took the previous report."""
    s = _get_session()
    _check(s)
    _close_step(s, metrics)
    item = {"metrics": dict(metrics), "checkpoint": checkpoint}
    while True:
        try:
            s.results.put(item, timeout=0.05)
            break
        except queue.Full:
            _check(s)
    # the wait above is the trainer's backpressure, not this rank's step time
    s.step_t0 = time.monotonic()


def get_checkpoint():
    """The checkpoint to resume from, if the run was restored."""
    return _get_session().resume_checkpoint


def get_dataset_shard(name: str = "train") -> DataShard:
    """This rank's :class:`DataShard` of the trainer's ``datasets[name]``."""
    shards = _get_session().dataset_shards
    if name not in shards:
        raise KeyError(f"no dataset shard {name!r}: pass datasets={{{name!r}: "
                       f"...}} to the Trainer (available: {sorted(shards)})")
    return shards[name]


def get_collective_group() -> str | None:
    """Name of the gang's collective group (``backend="dcn"``), or None
    for the torch.distributed backend (where the process group is the
    collective)."""
    return _get_session().collective_group


def get_resume_seq() -> int:
    """0 on the first launch; incremented by every resume."""
    return _get_session().resume_seq


def get_world_rank() -> int:
    return _get_session().world_rank


def get_world_size() -> int:
    return _get_session().world_size


def get_local_rank() -> int:
    return _get_session().local_rank
