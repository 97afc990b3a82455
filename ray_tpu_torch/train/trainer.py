"""The trainer: the user-facing training service.

The port's counterpart of ray_tpu/train/trainer.py's ``JaxTrainer``,
named :class:`Trainer` (the JAX package's ``TorchTrainer`` is its
separate gloo-DDP trainer, ray_tpu/train/torch_trainer.py, which this is
not). ``train_loop_per_worker(config)`` runs on every worker of a gang
from the injected runtime (``train/worker_group.py``) and reports through
``ray_tpu_torch.train.session.report(metrics, checkpoint=...)``; with
``datasets={"train": blocks}`` each worker reads its elastic shard with
``session.get_dataset_shard("train")``.

Failure handling is two-tier, as in JAX:

- **in-place resume** (the ``"dcn"`` backend): survivors keep their workers
  and device state; the executor heals the gang (respawn or shrink,
  re-grow when it can), reforms the collective, rebalances the dataset
  shards and warm-restarts the loops from the latest valid checkpoint.
  Budgeted by ``RunConfig.max_inplace_resumes``.
- **gang restart** (the fallback, and the only path of the ``"torch"``
  backend, whose process group cannot be reformed): tear everything
  down, start again, resume from the checkpoint. Budgeted by
  ``RunConfig.max_failures``.

Both are counted in ``Result.resumes``, and each resume goes to the
runtime's recorder as a ``train.resume`` span (``mode``, its latency), in
place of JAX's Prometheus counters.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.train.backend_executor import (
    QUIESCE_TIMEOUT_S,
    BackendExecutor,
    TrainingFailedError,
)
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointCorruptError,
    CheckpointManager,
    verify_checkpoint,
)
from ray_tpu_torch.train.worker_group import InProcessTrainRuntime

logger = logging.getLogger(__name__)

# worker-loop exception types that mean "the infrastructure failed", not
# "the user's code is wrong": retriable under the failure budgets
INFRA_ERROR_TYPES = frozenset({
    "CollectiveAbortError",    # a peer died mid-collective
    "CollectiveTimeoutError",  # a stranded collective op
    "GetTimeoutError",         # an object fetch outlived its deadline
    "WorkerDiedError",         # a rank's worker vanished (synthesized)
    "InjectedFault",           # a chaos-injected crash
    "CheckpointCorruptError",  # a torn or bit-rotted checkpoint on restore
})


def _record_resume(runtime, mode: str, seconds: float) -> None:
    """A resume of ``mode`` that took ``seconds``, to the runtime's
    recorder; accounting never blocks recovery."""
    now = time.monotonic()
    try:
        runtime.record("train", "train.resume", now - seconds, now,
                       {"mode": mode, "seconds": seconds})
    except Exception:  # noqa: BLE001
        logger.exception("recording a resume failed")


@dataclass
class ScalingConfig:
    """JAX's ScalingConfig. ``backend="dcn"``: each worker trains alone,
    synced through the gang's collective (in-place resumable);
    ``"torch"``: one torch.distributed group over the workers.
    ``min_workers``: the elastic floor (None: not elastic).
    ``max_restarts`` > 0 lets the heal respawn a dead rank (that many
    times in all) before it shrinks. ``device``: what the torch backend's
    group runs on ("cuda": NCCL, "cpu": gloo). ``resources_per_worker``
    and ``placement_strategy`` go to runtimes that place workers."""

    num_workers: int = 1
    resources_per_worker: dict = field(default_factory=lambda: {"CPU": 1})
    placement_strategy: str = "SPREAD"
    backend: str = "dcn"
    min_workers: int | None = None
    max_restarts: int = 0
    device: str = "cuda"


@dataclass
class RunConfig:
    """JAX's RunConfig and FailureConfig: the two failure budgets are
    separate (an in-place resume is cheap and common, a gang restart
    expensive and rare). ``on_report`` is called once per completed
    lockstep step with rank 0's metrics before they enter the history;
    its exceptions are logged. ``quiesce_timeout_s`` is the JAX
    package's ``train_quiesce_timeout_s`` config knob."""

    name: str = "train_run"
    storage_path: str | None = None
    max_failures: int = 0
    checkpoint_num_to_keep: int = 2
    max_inplace_resumes: int = 8
    on_report: Callable[[dict], None] | None = None
    quiesce_timeout_s: float = QUIESCE_TIMEOUT_S


@dataclass
class Result:
    metrics: dict | None
    checkpoint: Checkpoint | None
    metrics_history: list[dict]
    error: str | None = None
    resumes: dict | None = None  # {"inplace": n, "gang": m}


class Trainer:
    """Gang-scheduled data-parallel training with elastic resume (JAX's
    ``JaxTrainer``). ``runtime`` makes the gang (default: an
    ``InProcessTrainRuntime``, its workers threads of this process;
    ``ProcessTrainRuntime``: a process a worker); its
    ``errors``, if it has them, are the infrastructure errors its calls
    raise (as ``RayActorError`` and ``GetTimeoutError``), retried under
    the failure budgets like ``RuntimeError`` and ``TimeoutError``."""

    def __init__(self, train_loop_per_worker: Callable[[dict], Any],
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 resume_from_checkpoint: Checkpoint | None = None,
                 runtime=None):
        self.train_fn = train_loop_per_worker
        self.config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.runtime = runtime if runtime is not None else InProcessTrainRuntime()

    @staticmethod
    def _shutdown_quietly(executor: BackendExecutor | None) -> None:
        """Teardown never masks the failure that caused it."""
        if executor is None:
            return
        try:
            executor.shutdown()
        except Exception as e:  # noqa: BLE001 — teardown is best-effort
            logger.warning("executor shutdown raised (%s: %s); suppressing so "
                           "the original failure propagates", type(e).__name__, e)

    def _resume_checkpoint(self, ckpt_mgr: CheckpointManager,
                           suspect: Checkpoint | None):
        """Newest checkpoint that passes verification; when the failure
        was a corrupt restore, the checkpoint restored from (``suspect``)
        is dropped first so the retry falls back."""
        if suspect is not None:
            seed = self.resume_from_checkpoint
            if seed is not None and suspect.path == seed.path:
                logger.warning("resume_from_checkpoint failed restore (%s); "
                               "dropping it", suspect.path)
                self.resume_from_checkpoint = None
            elif ckpt_mgr.owns(suspect):
                logger.warning("discarding checkpoint that failed restore: %s",
                               suspect.path)
                ckpt_mgr.discard(suspect)
            else:
                logger.warning("corrupt checkpoint %s is outside this run's "
                               "manager; leaving it in place", suspect.path)
        valid = ckpt_mgr.latest_valid(full=False)
        if valid is not None:
            return valid
        if self.resume_from_checkpoint is not None:
            try:
                verify_checkpoint(self.resume_from_checkpoint.path)
            except CheckpointCorruptError as e:
                logger.warning("resume_from_checkpoint failed verification "
                               "(%s); dropping it and restarting from scratch", e)
                self.resume_from_checkpoint = None
        return self.resume_from_checkpoint

    def _executor(self) -> BackendExecutor:
        s = self.scaling
        return BackendExecutor(
            s.num_workers, resources_per_worker=s.resources_per_worker,
            strategy=s.placement_strategy, backend=s.backend,
            min_workers=s.min_workers, datasets=self.datasets,
            max_restarts=s.max_restarts, runtime=self.runtime, device=s.device,
            quiesce_timeout_s=self.run_config.quiesce_timeout_s)

    def fit(self) -> Result:
        """Run to completion. A worker failure resumes in place when the
        backend supports it, else restarts the whole gang, each under its
        own budget."""
        storage = self.run_config.storage_path or tempfile.mkdtemp(
            prefix=f"ray_tpu_torch_{self.run_config.name}_")
        ckpt_mgr = CheckpointManager(
            os.path.join(storage, "checkpoints"),
            num_to_keep=self.run_config.checkpoint_num_to_keep)
        gang_left = self.run_config.max_failures
        inplace_left = self.run_config.max_inplace_resumes
        resume = self.resume_from_checkpoint
        history: list[dict] = []
        resumes = {"inplace": 0, "gang": 0}
        executor: BackendExecutor | None = None
        gang_t0: float | None = None

        while True:
            try:
                if executor is None:
                    executor = self._executor()
                    executor.start()
                    if gang_t0 is not None:
                        _record_resume(self.runtime, "gang",
                                       time.monotonic() - gang_t0)
                        gang_t0 = None
                executor.start_training(
                    self.train_fn, self.config,
                    resume_ckpt_path=resume.path if resume else None,
                    resume_seq=resumes["inplace"] + resumes["gang"])
                final = self._drain(executor, ckpt_mgr, history)
                self._shutdown_quietly(executor)
                return Result(metrics=final, checkpoint=ckpt_mgr.latest_valid(),
                              metrics_history=history, resumes=dict(resumes))
            except (TimeoutError, RuntimeError,
                    *getattr(self.runtime, "errors", ())) as e:
                # infra failures (a peer's death, a lost worker, a torn
                # checkpoint, injected chaos) are retriable; anything else
                # the user loop raised is the user's error and propagates
                etype = getattr(e, "error_type", "") \
                    if isinstance(e, TrainingFailedError) else ""
                infra = (not isinstance(e, TrainingFailedError)
                         or etype in INFRA_ERROR_TYPES
                         or bool(getattr(e, "dead_ranks", [])))
                can_inplace = (infra and executor is not None
                               and executor.supports_inplace_resume()
                               and inplace_left > 0)
                if isinstance(e, TrainingFailedError) and not (
                        infra and (gang_left > 0 or can_inplace)):
                    self._shutdown_quietly(executor)
                    raise
                suspect = None
                epath = getattr(e, "error_path", "")
                if epath:
                    suspect = Checkpoint(epath)
                elif etype == "CheckpointCorruptError":
                    suspect = resume
                resume = self._resume_checkpoint(ckpt_mgr, suspect)
                if can_inplace:
                    t0 = time.monotonic()
                    try:
                        world = executor.heal_inplace()
                    except Exception as he:  # noqa: BLE001 — fall back
                        logger.warning("in-place resume failed (%s: %s); falling "
                                       "back to gang restart",
                                       type(he).__name__, he)
                        if isinstance(e, TrainingFailedError) and gang_left <= 0:
                            self._shutdown_quietly(executor)
                            raise e
                    else:
                        inplace_left -= 1
                        resumes["inplace"] += 1
                        _record_resume(self.runtime, "inplace",
                                       time.monotonic() - t0)
                        logger.warning("worker gang failed (%s); resumed IN-PLACE "
                                       "at world %d (%d in-place resumes left) "
                                       "from %s", e, world, inplace_left, resume)
                        continue
                self._shutdown_quietly(executor)
                executor = None
                if gang_left <= 0:
                    return Result(metrics=history[-1] if history else None,
                                  checkpoint=ckpt_mgr.latest_valid(),
                                  metrics_history=history,
                                  error=f"training failed: {e}",
                                  resumes=dict(resumes))
                gang_left -= 1
                resumes["gang"] += 1
                gang_t0 = time.monotonic()
                logger.warning("worker gang failed (%s); restarting (%d retries "
                               "left) from %s", e, gang_left, resume)

    def _drain(self, executor: BackendExecutor, ckpt_mgr: CheckpointManager,
               history: list[dict]) -> dict | None:
        """Lockstep result loop: a step is recorded once every rank
        reported it, rank 0's metrics authoritative. A dead rank or a
        worker error raises a TrainingFailedError with ``error_type`` (a
        survivor's CollectiveAbortError preferred over a generic death),
        ``error_path`` and ``dead_ranks``, after the reports of its round
        are recorded. (JAX raises first, so a step that completes in the
        round of a death loses its checkpoint, and a death that closely
        follows a checkpoint's report resumes from the one before.)"""
        n = executor.num_workers
        pending = [deque() for _ in range(n)]
        finished = [False] * n
        final = None
        while True:
            rounds = executor.next_results(timeout=15.0)
            dead = [r for r, res in enumerate(rounds) if res["type"] == "dead"]
            errors = [(r, res) for r, res in enumerate(rounds)
                      if res["type"] == "error"]
            for rank, res in enumerate(rounds):
                if res["type"] == "finished":
                    finished[rank] = True
                elif res["type"] == "report":
                    pending[rank].append(res)
            while all(pending):
                step_reports = [q.popleft() for q in pending]
                metrics = step_reports[0]["metrics"]
                cb = self.run_config.on_report
                if cb is not None:
                    try:
                        cb(metrics)
                    except Exception:  # noqa: BLE001 — a consumer's bug
                        logger.exception("RunConfig.on_report callback failed")
                history.append(metrics)
                final = metrics
                ckpt = next((r.get("checkpoint") for r in step_reports
                             if r.get("checkpoint") is not None), None)
                if ckpt is not None:
                    ckpt_mgr.register(ckpt, metrics)
            if errors or dead:
                typed = next((res for _, res in errors
                              if res.get("error_type") == "CollectiveAbortError"),
                             None)
                pick = typed or (errors[0][1] if errors else None)
                if pick is not None:
                    err = TrainingFailedError(pick["error"])
                    err.error_type = pick.get("error_type", "")
                    err.error_path = next(
                        (res.get("error_path", "") for _, res in errors
                         if res.get("error_type") == "CheckpointCorruptError"
                         and res.get("error_path")),
                        pick.get("error_path", ""))
                else:
                    err = TrainingFailedError(
                        f"worker rank(s) {dead} died: {rounds[dead[0]]['error']}")
                    err.error_type = "WorkerDiedError"
                err.dead_ranks = dead
                raise err
            if all(finished):
                if any(pending):
                    raise TrainingFailedError(
                        "workers reported unequal numbers of results: "
                        f"{[len(q) for q in pending]} undrained per rank")
                return final
