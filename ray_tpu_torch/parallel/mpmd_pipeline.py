"""Cross-slice MPMD pipeline parallelism over an injected runtime.

Mirrors ray_tpu/parallel/mpmd_pipeline.py. In-mesh pipelining
(``pipeline.py``) runs every stage in one SPMD program; here each stage
is a program of its own on workers of its own (asymmetric per-stage
worker counts allowed), and microbatch activations and their gradients
cross stage boundaries as host numpy arrays, on a 1F1B or GPipe
schedule.

Layout: one p2p group spans every stage worker; global rank =
``stage_offset + dp_index``, the offsets being the cumsum of the stage
sizes. Microbatch ``m`` of stage ``s`` is owned by replica ``m % dp_s``,
so boundary routing is a pure function of the sizes: sender
``offs[s] + m % dp_s`` -> receiver ``offs[s+1] + m % dp_(s+1)``. Within
a stage the replicas sum their gradients on a thread that overlaps the
tail sends of the same step.

Elasticity: a dead stage worker ends its loop; the driver quiesces every
stage, heals the dead worker in place, reforms the groups under a new
epoch and resumes every stage from the last step that all of them have
checkpointed: no gang restart. Spans ``pipeline.microbatch`` (each
action), ``pipeline.step`` (compute / p2p wait / allreduce wait) and
``pipeline.heal`` go to the runtime's recorder, so the bubble is
measured beside the analytic (S-1)/(M+S-1).

The runtime calls (workers, lanes, the stage sum, the session, the fault
site, spans) come from ``runtime`` (``pipeline_runtime.py``;
``InProcessPipelineRuntime``, a thread per worker, by default). The
stage functions are user code: their trees may hold numpy arrays or
torch tensors, and they own autograd inside the stage.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.parallel.pipeline_runtime import InProcessPipelineRuntime
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.utils.trees import tree_map

logger = logging.getLogger(__name__)

# The JAX package's runtime-config defaults this module reads
# (ray_tpu/_private/config.py:181,185,195).
PIPELINE_MICROBATCHES = 8
PIPELINE_P2P_TIMEOUT_S = 60.0
QUIESCE_TIMEOUT_S = 30.0

# Error types a heal can cure (ray_tpu/train/trainer.py INFRA_ERROR_TYPES).
INFRA_ERROR_TYPES = frozenset({
    "CollectiveAbortError", "CollectiveTimeoutError", "GetTimeoutError",
    "WorkerDiedError", "InjectedFault", "CheckpointCorruptError",
})


class TrainingFailedError(RuntimeError):
    """A stage failed in its own code, or the heal budget ran out."""

    error_type: str = ""
    error_path: str = ""


# --------------------------------------------------------------------------
# schedule
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PipelineSchedule:
    """Per-stage action order for ``M`` microbatches over ``S`` stages.

    ``style="1f1b"`` (default): stage ``s`` warms up with
    ``min(M, S-1-s)`` forwards, then alternates one-forward-one-backward,
    then drains the remaining backwards; peak live activations per stage
    is ``S - s``, independent of ``M``. ``style="gpipe"`` is the
    degenerate case (warmup = ``M``): all forwards, then all backwards,
    holding ``M`` activations.
    """

    num_stages: int
    microbatches: int
    style: str = "1f1b"

    def __post_init__(self):
        if self.style not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown schedule style {self.style!r}")
        if self.num_stages < 1 or self.microbatches < 1:
            raise ValueError("need >=1 stage and >=1 microbatch")

    def warmup(self, stage: int) -> int:
        if self.style == "gpipe":
            return self.microbatches
        return min(self.microbatches, self.num_stages - 1 - stage)

    def actions(self, stage: int) -> list[tuple[str, int]]:
        """[("F", mb) | ("B", mb), ...] in execution order for `stage`."""
        m = self.microbatches
        warm = self.warmup(stage)
        acts: list[tuple[str, int]] = []
        f = b = 0
        while f < min(warm, m):
            acts.append(("F", f))
            f += 1
        while f < m:
            acts.append(("F", f))
            acts.append(("B", b))
            f += 1
            b += 1
        while b < m:
            acts.append(("B", b))
            b += 1
        return acts

    def peak_live(self, stage: int) -> int:
        """Max activations held at once: the 1F1B memory win."""
        return min(self.microbatches, self.warmup(stage) + 1)

    def bubble_fraction(self) -> float:
        """Analytic pipeline-fill bubble: (S-1)/(M+S-1)."""
        s, m = self.num_stages, self.microbatches
        return (s - 1) / float(m + s - 1)


# --------------------------------------------------------------------------
# user-facing stage description
# --------------------------------------------------------------------------

@dataclass
class StageSpec:
    """One pipeline stage: its worker count and its math.

    ``init_fn(config) -> params``;
    ``forward_fn(params, x) -> (y, saved)``;
    ``backward_fn(params, saved, dy) -> (dx, grads)`` where ``grads``
    matches the params tree. The LAST stage also provides
    ``loss_fn(params, y, target) -> (loss, dy)``. Arrays are host numpy
    at the boundary (the p2p lanes carry numpy; numpy has no bf16, so a
    bf16 activation crosses as f32, exactly); inside a stage the
    functions may run on the card and keep their autograd graph in
    ``saved``, which never leaves the worker.
    """

    num_workers: int = 1
    init_fn: Callable[[dict], Any] = None
    forward_fn: Callable[[Any, Any], tuple] = None
    backward_fn: Callable[[Any, Any, Any], tuple] = None
    loss_fn: Callable[[Any, Any, Any], tuple] | None = None


@dataclass
class PipelineResult:
    """What :meth:`MpmdPipeline.fit` hands back."""

    losses: list[float] = field(default_factory=list)
    steps_completed: int = 0
    heals: int = 0
    gang_restarts: int = 0  # always 0: heal is in-place by construction
    bubble_by_stage: dict[int, float] = field(default_factory=dict)
    bubble_fraction: float = 0.0
    stage_world_sizes: list[int] = field(default_factory=list)
    final_params: list[Any] | None = None
    metrics: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# worker-side stage loop
# --------------------------------------------------------------------------

def _tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def _tree_scale(t, k):
    return tree_map(lambda x: x * k, t)


def _sgd(p, g, lr: float):
    """``p - lr * g``, keeping p's device and dtype; outside autograd."""
    if isinstance(p, torch.Tensor):
        with torch.no_grad():
            g = torch.as_tensor(g, device=p.device)
            return (p - lr * g).to(p.dtype)
    return p - lr * g


def _stage_loop(session, config: dict) -> None:
    """The per-worker pipeline program: one (stage, dp replica), reached
    through its runtime session."""
    stages: list[StageSpec] = config["stages"]
    data_fn = config["data_fn"]
    s_idx, dp_rank = session.stage, session.dp_rank
    sizes = list(config["stage_sizes"])
    n_stages = len(sizes)
    dp_size = sizes[s_idx]
    offs = [0] * n_stages
    for i in range(1, n_stages):
        offs[i] = offs[i - 1] + sizes[i - 1]
    g_rank = offs[s_idx] + dp_rank
    num_steps = int(config["num_steps"])
    m_total = int(config["microbatches"])
    lr = float(config.get("lr", 0.05))
    p2p_timeout = float(config.get("p2p_timeout_s") or PIPELINE_P2P_TIMEOUT_S)
    ckpt_dir = config.get("ckpt_dir")
    ckpt_every = int(config.get("ckpt_every", 1))
    spec = stages[s_idx]
    is_first, is_last = s_idx == 0, s_idx == n_stages - 1

    # one-shot fault arming: only the first incarnation arms, so healed
    # incarnations do not fire the same plan again
    if config.get("fault_specs") and session.resume_seq == 0:
        session.arm(config["fault_specs"])

    params = spec.init_fn(dict(config.get("user_config") or {}, stage=s_idx))
    start_step = 0
    if session.checkpoint is not None:
        d = session.checkpoint.to_dict()  # CheckpointCorruptError if torn
        params = d["params"]
        start_step = int(d["step"])

    sched = PipelineSchedule(n_stages, m_total, config.get("schedule", "1f1b"))
    acts = [(kind, m) for kind, m in sched.actions(s_idx)
            if m % dp_size == dp_rank]
    n_my_backwards = sum(1 for kind, _ in acts if kind == "B")

    def _boundary(op: str, m: int, step: int) -> str | None:
        # the pipeline.stage fault site: die and exit act inside
        # fire(); "drop" is ours to implement (skip the send, so that the
        # peer's recv deadline trips: a typed CollectiveTimeoutError)
        return session.fire("pipeline.stage", stage=s_idx, mb=m, op=op,
                            rank=g_rank, step=step)

    for step in range(start_step, num_steps):
        t_step = time.monotonic()
        compute_s = p2p_wait_s = ar_wait_s = 0.0
        saved: dict[int, Any] = {}
        acc_grads = None
        loss_sum, loss_n = 0.0, 0
        ar_thread: threading.Thread | None = None
        ar_box: dict[str, Any] = {}
        done_b = 0

        for kind, m in acts:
            t_mb = time.monotonic()
            if kind == "F":
                if is_first:
                    x, _tgt = data_fn(step, m)
                    x = np.asarray(x)
                else:
                    _boundary("recv", m, step)
                    t0 = time.monotonic()
                    x = session.recv(offs[s_idx - 1] + m % sizes[s_idx - 1],
                                     p2p_timeout)
                    p2p_wait_s += time.monotonic() - t0
                t0 = time.monotonic()
                y, sv = spec.forward_fn(params, x)
                saved[m] = sv
                compute_s += time.monotonic() - t0
                if not is_last:
                    if _boundary("send", m, step) != "drop":
                        t0 = time.monotonic()
                        session.send(np.asarray(y),
                                     offs[s_idx + 1] + m % sizes[s_idx + 1])
                        p2p_wait_s += time.monotonic() - t0
                else:
                    _x, tgt = data_fn(step, m)
                    t0 = time.monotonic()
                    loss, dy = spec.loss_fn(params, y, np.asarray(tgt))
                    compute_s += time.monotonic() - t0
                    loss_sum += float(loss)
                    loss_n += 1
                    saved[m] = (saved[m], dy)
            else:  # backward
                if is_last:
                    sv, dy = saved.pop(m)
                else:
                    _boundary("recv", m, step)
                    t0 = time.monotonic()
                    dy = session.recv(offs[s_idx + 1] + m % sizes[s_idx + 1],
                                      p2p_timeout)
                    p2p_wait_s += time.monotonic() - t0
                    sv = saved.pop(m)
                t0 = time.monotonic()
                dx, grads = spec.backward_fn(params, sv, dy)
                compute_s += time.monotonic() - t0
                acc_grads = grads if acc_grads is None \
                    else _tree_add(acc_grads, grads)
                done_b += 1
                if done_b == n_my_backwards and dp_size > 1:
                    # the gradient sum is complete: start the stage sum
                    # now, overlapped with this microbatch's dx send
                    local = _tree_scale(acc_grads, 1.0 / m_total)

                    def _ar(local=local):
                        try:
                            ar_box["grads"] = session.allreduce_sum(
                                local, p2p_timeout)
                        except BaseException as e:  # noqa: BLE001 — re-raised by the loop
                            ar_box["error"] = e

                    ar_thread = threading.Thread(
                        target=_ar, daemon=True, name="pipeline_allreduce")
                    ar_thread.start()
                if not is_first:
                    if _boundary("send", m, step) != "drop":
                        t0 = time.monotonic()
                        session.send(np.asarray(dx),
                                     offs[s_idx - 1] + m % sizes[s_idx - 1])
                        p2p_wait_s += time.monotonic() - t0
            session.record("train", "pipeline.microbatch", t_mb,
                           time.monotonic(),
                           {"stage": s_idx, "mb": m, "op": kind,
                            "rank": g_rank, "step": step})

        if dp_size > 1:
            if ar_thread is None:  # no owned microbatch carried a grad
                if acc_grads is None:
                    acc_grads = _tree_scale(params, 0.0)
                g_mean = session.allreduce_sum(
                    _tree_scale(acc_grads, 1.0 / m_total), p2p_timeout)
            else:
                t0 = time.monotonic()
                ar_thread.join()
                ar_wait_s += time.monotonic() - t0
                if "error" in ar_box:
                    raise ar_box["error"]
                g_mean = ar_box["grads"]
        else:
            g_mean = _tree_scale(acc_grads, 1.0 / m_total)

        params = tree_map(lambda p, g: _sgd(p, g, lr), params, g_mean)

        wall = max(1e-9, time.monotonic() - t_step)
        bubble = min(1.0, (p2p_wait_s + ar_wait_s) / wall)
        session.record("train", "pipeline.step", t_step, time.monotonic(),
                       {"stage": s_idx, "rank": g_rank, "step": step + 1,
                        "compute_s": round(compute_s, 6),
                        "p2p_wait_s": round(p2p_wait_s, 6),
                        "allreduce_wait_s": round(ar_wait_s, 6),
                        "bubble": round(bubble, 6)})

        ckpt_path = ""
        if (ckpt_dir and dp_rank == 0
                and ((step + 1) % ckpt_every == 0 or step + 1 == num_steps)):
            ckpt_path = os.path.join(ckpt_dir, f"stage{s_idx}",
                                     f"step_{step + 1:06d}")
            Checkpoint.from_dict({"step": step + 1, "params": params},
                                 path=ckpt_path)
            _prune_stage_ckpts(os.path.join(ckpt_dir, f"stage{s_idx}"), keep=2)

        metrics = {
            "step": step + 1, "stage": s_idx, "dp_rank": dp_rank,
            "compute_s": compute_s, "p2p_wait_s": p2p_wait_s,
            "allreduce_wait_s": ar_wait_s, "bubble": bubble,
            "ckpt": ckpt_path, "mbs": loss_n,
        }
        if is_last and loss_n:
            metrics["loss"] = loss_sum / loss_n
        if config.get("return_params") and step + 1 == num_steps:
            metrics["params"] = params
        session.report(metrics)


def _prune_stage_ckpts(stage_dir: str, keep: int = 2) -> None:
    try:
        kids = sorted(d for d in os.listdir(stage_dir) if d.startswith("step_"))
    except OSError:
        return
    for d in kids[:-keep]:
        shutil.rmtree(os.path.join(stage_dir, d), ignore_errors=True)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

class MpmdPipeline:
    """Driver for an MPMD pipeline.

    One worker per (stage, dp replica) on ``runtime``
    (``InProcessPipelineRuntime()`` when None), one p2p group over every
    stage worker, a gradient sum per stage wider than one worker.
    ``fit()`` runs the monitor loop and the in-place heal cycle; it never
    gang-restarts. ``resources_per_worker`` and ``max_restarts`` go to
    the runtime's ``start`` (the in-process runtime places no workers, so
    it has no use for the first; the second bounds the respawns of each
    worker place).
    """

    def __init__(self, stages: list[StageSpec], *,
                 data_fn: Callable[[int, int], tuple],
                 num_steps: int,
                 microbatches: int | None = None,
                 schedule: str = "1f1b",
                 lr: float = 0.05,
                 user_config: dict | None = None,
                 ckpt_dir: str | None = None,
                 ckpt_every: int = 1,
                 resources_per_worker: dict | None = None,
                 max_heals: int = 4,
                 max_restarts: int = 2,
                 quiesce_timeout_s: float | None = None,
                 poll_s: float = 5.0,
                 fault_specs: list[dict] | None = None,
                 p2p_timeout_s: float | None = None,
                 return_params: bool = False,
                 name: str | None = None,
                 runtime=None):
        if len(stages) < 1:
            raise ValueError("need at least one stage")
        if stages[-1].loss_fn is None:
            raise ValueError("last stage needs a loss_fn")
        self.stages = list(stages)
        self.data_fn = data_fn
        self.name = name or f"pipe-{uuid.uuid4().hex[:6]}"
        self.num_steps = int(num_steps)
        self.microbatches = int(microbatches or PIPELINE_MICROBATCHES)
        self.schedule = schedule
        # schedule validity is checked up front, not on the workers
        PipelineSchedule(len(stages), self.microbatches, schedule)
        self.lr = lr
        self.user_config = dict(user_config or {})
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_heals = max_heals
        self.max_restarts = max_restarts
        self.quiesce_timeout_s = quiesce_timeout_s
        self.poll_s = float(poll_s)
        self.fault_specs = list(fault_specs or [])
        self.p2p_timeout_s = p2p_timeout_s
        self.return_params = return_params
        self._res = dict(resources_per_worker or {"CPU": 0.1})
        self.runtime = runtime if runtime is not None else InProcessPipelineRuntime()
        self._pipe = f"{self.name}-p2p"
        self.heals = 0
        self.gang_restarts = 0
        # per-stage {step: ckpt_path} as reported by dp-rank-0 workers
        self._ckpts: list[dict[int, str]] = [{} for _ in stages]

    # -- topology ---------------------------------------------------------

    def _sizes(self) -> list[int]:
        return [s.num_workers for s in self.stages]

    # -- setup ------------------------------------------------------------

    def _launch(self, resume_seq: int, resume_paths: dict[int, str | None]) -> None:
        sizes = self._sizes()
        for s, i, w in self.runtime.workers():
            cfg = {
                "stages": self.stages, "data_fn": self.data_fn,
                "stage_sizes": sizes, "num_steps": self.num_steps,
                "microbatches": self.microbatches,
                "schedule": self.schedule, "lr": self.lr,
                "user_config": self.user_config,
                "ckpt_dir": self.ckpt_dir, "ckpt_every": self.ckpt_every,
                "p2p_timeout_s": self.p2p_timeout_s,
                "fault_specs": self.fault_specs,
                "return_params": self.return_params,
            }
            self.runtime.launch(w, _stage_loop, cfg, resume_paths.get(s),
                                resume_seq)

    # -- resume target ----------------------------------------------------

    def _resume_paths(self) -> dict[int, str | None]:
        """Latest checkpoint step every stage HAS: stages must resume from
        the same step or the pipeline desynchronizes. No common step:
        everyone restarts from scratch."""
        common: set[int] | None = None
        for reg in self._ckpts:
            steps = set(reg)
            common = steps if common is None else (common & steps)
        if not common:
            return {}
        t = max(common)
        return {s: reg[t] for s, reg in enumerate(self._ckpts)}

    def _discard_ckpt(self, path: str) -> None:
        for reg in self._ckpts:
            for step, p in list(reg.items()):
                if p == path:
                    del reg[step]

    # -- heal cycle -------------------------------------------------------

    def _heal(self, resume_seq: int, suspect_stages: set[int] | None = None) -> None:
        """Quiesce ALL stages, heal dead workers in place, reform every
        group under a new epoch, relaunch from the last common
        checkpoint. Zero gang restarts by construction."""
        t0 = time.monotonic()
        workers = self.runtime.workers()
        logger.info("pipeline %s: quiescing %d workers for in-place heal",
                    self.name, len(workers))
        stuck = self.runtime.quiesce(float(self.quiesce_timeout_s
                                           or QUIESCE_TIMEOUT_S))
        if stuck:
            raise TrainingFailedError(
                f"pipeline {self.name}: workers {stuck} (stage, index) did not "
                "quiesce; each ends at its next runtime call")
        healed = set(suspect_stages or ())
        for s, _i, w in workers:
            if not self.runtime.alive(w):
                healed.add(s)
                self.runtime.respawn(w)
        epoch = self.runtime.reform()
        paths = self._resume_paths()
        self._launch(resume_seq, paths)
        self.heals += 1
        self.runtime.record(
            "train", "pipeline.heal", t0, time.monotonic(),
            {"pipe": self._pipe, "stages": sorted(healed), "epoch": epoch,
             "resume_step": next((int(os.path.basename(p).split("_")[1])
                                  for p in paths.values() if p), 0),
             "world": len(workers)})
        logger.info("pipeline %s healed stages %s (epoch %d, %d heals)",
                    self.name, sorted(healed), epoch, self.heals)

    # -- monitor loop -----------------------------------------------------

    def fit(self) -> PipelineResult:
        self.runtime.start(self._sizes(), self._pipe,
                           max_restarts=self.max_restarts,
                           resources=self._res)
        try:
            result = self._fit()
        except BaseException:
            self.runtime.shutdown()  # the error in flight is the one to see
            raise
        self.shutdown()
        return result

    def _fit(self) -> PipelineResult:
        self._launch(0, {})
        resume_seq = 0
        result = PipelineResult()
        losses: dict[int, list[tuple[float, int]]] = {}
        bubbles: dict[int, list[float]] = {}
        finished: set[tuple[int, int]] = set()
        final_params: dict[int, Any] = {}

        while len(finished) < len(self.runtime.workers()):
            infra: str | None = None
            suspects: set[int] = set()
            for w, r in self.runtime.results(self.poll_s):
                s, i = w.stage, w.index
                typ = r["type"]
                if typ == "report":
                    m = r["metrics"]
                    step = int(m.get("step", 0))
                    if "loss" in m:
                        losses.setdefault(step, []).append(
                            (float(m["loss"]), int(m.get("mbs", 1))))
                    bubbles.setdefault(s, []).append(float(m.get("bubble", 0.0)))
                    if m.get("ckpt"):
                        self._ckpts[s][step] = m["ckpt"]
                    if "params" in m:
                        final_params[s] = m["params"]
                    result.steps_completed = max(result.steps_completed, step)
                elif typ == "finished":
                    finished.add((s, i))
                else:  # error
                    et = r.get("error_type", "")
                    if et == "CheckpointCorruptError" and r.get("error_path"):
                        self._discard_ckpt(r["error_path"])
                    if et in INFRA_ERROR_TYPES:
                        infra = infra or et
                        if et in ("WorkerDiedError", "InjectedFault"):
                            suspects.add(s)
                    else:
                        err = TrainingFailedError(
                            f"pipeline stage {s} worker {i} failed:\n"
                            f"{r.get('error', '')}")
                        err.error_type = et
                        err.error_path = r.get("error_path", "")
                        raise err
            if infra is not None:
                if self.heals >= self.max_heals:
                    err = TrainingFailedError(
                        f"pipeline {self.name}: heal budget exhausted "
                        f"({self.max_heals}) after {infra}")
                    err.error_type = infra
                    raise err
                resume_seq += 1
                finished.clear()
                self._heal(resume_seq, suspects)

        for step in sorted(losses):
            pairs = losses[step]
            tot = sum(n for _, n in pairs) or 1
            result.losses.append(sum(v * n for v, n in pairs) / tot)
        result.heals = self.heals
        result.gang_restarts = self.gang_restarts
        result.bubble_by_stage = {s: sum(v) / len(v) for s, v in bubbles.items() if v}
        if result.bubble_by_stage:
            result.bubble_fraction = (sum(result.bubble_by_stage.values())
                                      / len(result.bubble_by_stage))
        result.stage_world_sizes = self._sizes()
        if final_params:
            result.final_params = [final_params.get(s)
                                   for s in range(len(self.stages))]
        result.metrics = {"steps": result.steps_completed,
                          "pipe_group": self._pipe}
        return result

    def shutdown(self) -> None:
        """End every worker's loop; raise if one does not end."""
        stuck = self.runtime.shutdown()
        if stuck:
            raise TrainingFailedError(
                f"pipeline {self.name}: workers {stuck} (stage, index) still "
                "running after shutdown")
