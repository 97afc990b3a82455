"""The ray_tpu runtime hosts the port's MPMD pipeline on its own actors.

The port's ``MpmdPipeline`` reaches its workers through a runtime value
(``ray_tpu_torch/parallel/pipeline_runtime.py``); here it is built from
ray_tpu, as JAX's pipeline builds its own (ray_tpu/parallel/
mpmd_pipeline.py ``_setup``, ``_heal``):

- ``start``: one ``WorkerGroup`` gang a stage (one actor process a
  worker), global rank ``offs[s] + i``, one ray_tpu collective group over
  every worker for the p2p lanes, and a sum group for each stage wider
  than one worker (a one-worker stage sums nothing);
- the session's ``send`` / ``recv``: ``paced_send`` / ``paced_recv`` on
  that group; ``allreduce_sum``: ``dcn_allreduce_grads(op="sum")`` over
  the stage's group, as JAX's pipeline sums;
- ``launch`` starts ``fn(session, config)`` on a thread of the actor;
  ``results`` drains each worker's reports (a worker whose call fails at
  the actor layer, or whose process lost its session, gives
  ``WorkerDiedError``);
- ``quiesce``: ``abort_all_local`` on every actor, then waits for its
  loop; ``respawn``: ``WorkerGroup.heal``; ``reform``: JAX's idiom, the
  p2p group's epoch channel bumped past every member's live epoch and
  every member re-rendezvoused under it, then each sum group's
  ``reform_collective``;
- ``arm`` / ``fire``: ray_tpu's ``fault_injection`` in the worker
  process (``exit`` is a real process exit); ``record``: the worker's
  spans go to ray_tpu's flight recorder, ``fit``'s own to a list.

Held, on JAX's toy stages and baseline (tests/test_mpmd_pipeline.py:97-148,
copied): 1F1B and GPipe bit-equal to the baseline with no heal; ``[1, 2]``
workers within atol 1e-12; JAX's stage-kill script (rank 1 exits at its
11th boundary) heals in place, with losses exactly the baseline's, and
JAX's ``MpmdPipeline`` under the same script on the same cluster gives
the same losses, heals and gang restarts.
"""

import contextlib
import os
import queue
import signal
import sys
import threading
import time
import uuid

import cloudpickle
import numpy as np
import pytest

import ray_tpu
from ray_tpu.cluster_utils import Cluster
from ray_tpu.parallel import MpmdPipeline as JMpmdPipeline
from ray_tpu.parallel import StageSpec as JStageSpec
from ray_tpu.train.worker_group import WorkerGroup
from ray_tpu_torch.parallel import MpmdPipeline, StageSpec

# worker processes cannot import the tests directory: ship by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Fail the test (TimeoutError in the main thread) past ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"test still running after {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"CPU": 8, "memory": 4 * 2**30})
    c.connect()
    yield c
    c.shutdown()


# ---------------------------------------------------------------------------
# the worker side: runs in the actor processes
# ---------------------------------------------------------------------------


class _RaySession:
    """A worker's side of the runtime, for one launch, over ray_tpu."""

    def __init__(self, place: dict, pipe: str, sum_group, resume_path,
                 resume_seq: int):
        from ray_tpu_torch.train.checkpoint import Checkpoint

        self.stage, self.dp_rank = place["stage"], place["index"]
        self.rank, self.launch_id = place["rank"], place["launch_id"]
        self.resume_seq = resume_seq
        self.checkpoint = Checkpoint(resume_path) if resume_path else None
        self._pipe, self._sum_group = pipe, sum_group
        self.results: queue.Queue = queue.Queue()
        self.finished = threading.Event()
        self.error: BaseException | None = None
        self.ended = False  # the terminal result was handed over

    def arm(self, fault_specs) -> None:
        from ray_tpu._private import fault_injection

        fault_injection.configure(fault_specs)

    def fire(self, site: str, **ctx):
        from ray_tpu._private import fault_injection

        return fault_injection.fire(site, **ctx)

    def send(self, x, dst: int) -> None:
        from ray_tpu.collective import collective as col

        col.paced_send(np.asarray(x), dst, self._pipe, owner=self._pipe)

    def recv(self, src: int, timeout: float):
        from ray_tpu.collective import collective as col

        return col.paced_recv(src, self._pipe, timeout=timeout,
                              owner=self._pipe)

    def allreduce_sum(self, tree, timeout: float):
        from ray_tpu.train import dcn_allreduce_grads

        return dcn_allreduce_grads(tree, self._sum_group, op="sum",
                                   timeout=timeout)

    def report(self, metrics: dict) -> None:
        self.results.put({"type": "report", "metrics": metrics})

    def record(self, cat, name, t0, t1, attrs=None):
        from ray_tpu._private import flight_recorder

        flight_recorder.record(cat, name, t0, t1, attrs=attrs, flush=False)


def _start_on_worker(worker, fn, config, place, pipe, sum_group, resume_path,
                     resume_seq):
    old = worker.state.get("pipeline_thread")
    if old is not None and old.is_alive():
        raise RuntimeError(f"stage {place['stage']} worker {place['index']}: "
                           "the last loop is still running")
    sess = _RaySession(place, pipe, sum_group, resume_path, resume_seq)

    def run():
        try:
            fn(sess, config)
        except BaseException as e:  # noqa: BLE001 — reported to fit()
            sess.error = e
        finally:
            sess.finished.set()

    t = threading.Thread(target=run, daemon=True,
                         name=f"{pipe}-stage{place['stage']}-{place['index']}")
    worker.state["pipeline_session"] = sess
    worker.state["pipeline_thread"] = t
    t.start()
    return os.getpid()


def _import_port(worker):
    import ray_tpu_torch.parallel.mpmd_pipeline  # noqa: F401


def _has_session(worker, launch_id: int) -> bool:
    sess = worker.state.get("pipeline_session")
    return sess is not None and sess.launch_id == launch_id


def _drain_on_worker(worker, launch_id: int, timeout: float):
    """The reports given since the last drain, waiting up to ``timeout``
    for the first, then the loop's end once every report is out."""
    import traceback

    sess = worker.state.get("pipeline_session")
    if sess is None or sess.launch_id != launch_id:
        return {"lost": True}  # a fresh process: the runtime restarted it
    out = []
    deadline = time.monotonic() + timeout
    while not out:
        try:
            out.append(sess.results.get(timeout=0.05))
        except queue.Empty:
            if sess.finished.is_set() or time.monotonic() > deadline:
                break
    while True:
        try:
            out.append(sess.results.get_nowait())
        except queue.Empty:
            break
    if sess.finished.is_set() and sess.results.empty() and not sess.ended:
        sess.ended = True
        e = sess.error
        out.append({"type": "finished"} if e is None else {
            "type": "error", "error_type": type(e).__name__,
            "error": "".join(traceback.format_exception(e)),
            "error_path": str(getattr(e, "path", "") or "")})
    return {"results": out}


def _quiesce_on_worker(worker, timeout: float):
    from ray_tpu.collective import collective as col

    col.abort_all_local("pipeline heal: quiescing every stage")
    sess = worker.state.get("pipeline_session")
    t = worker.state.get("pipeline_thread")
    if sess is not None:
        sess.finished.wait(timeout)
    if t is not None:
        t.join(timeout=1.0)
    return {"ok": t is None or not t.is_alive()}


def _gather(refs, timeout: float) -> list:
    """Each ref's value or its exception, under one shared deadline."""
    deadline = time.monotonic() + timeout
    out = []
    for ref in refs:
        try:
            out.append(ray_tpu.get(ref, timeout=max(0.1, deadline
                                                    - time.monotonic())))
        except Exception as e:  # noqa: BLE001 — a dead or restarted worker
            out.append(e)
    return out


# ---------------------------------------------------------------------------
# the side of the process that runs fit()
# ---------------------------------------------------------------------------


class _Place:
    """One (stage, dp index) place and the actor that holds it now."""

    def __init__(self, stage, index, rank, actor):
        self.stage, self.index, self.rank, self.actor = stage, index, rank, actor
        self.launch_id = 0
        self.ended = True
        self.pending = None  # the drain call in flight


class RayPipelineRuntime:
    """``parallel/pipeline_runtime.py``'s contract over ray_tpu (module
    docstring)."""

    def __init__(self):
        self.spans = []
        self._wgs: list[WorkerGroup] = []
        self._places: list[_Place] = []
        self._wait_restart_s = 5.0

    def start(self, sizes, name, *, max_restarts=0, resources=None):
        from ray_tpu.collective import create_collective_group

        self._sizes, self._name = list(sizes), name
        self._wgs, imports = [], []
        for n in self._sizes:
            wg = WorkerGroup(n, dict(resources or {"CPU": 0.1}),
                             strategy="SPREAD", max_restarts=max_restarts)
            self._wgs.append(wg)
            # each worker imports the port while the next gang starts
            imports += [a.execute.remote(_import_port) for a in wg.workers]
        offs = np.cumsum([0] + self._sizes[:-1])
        self._places = [_Place(s, i, int(offs[s]) + i, a)
                        for s, wg in enumerate(self._wgs)
                        for i, a in enumerate(wg.workers)]
        # one create call over every stage: each member's init waits for
        # all ranks, so every init must be in flight before any gather
        create_collective_group([p.actor for p in self._places],
                                len(self._places),
                                [p.rank for p in self._places],
                                backend="cpu", group_name=name)
        self._sum_groups = [wg.init_collective(f"{name}-sum{s}")
                            if wg.num_workers > 1 else None
                            for s, wg in enumerate(self._wgs)]
        ray_tpu.get(imports, timeout=120)

    def workers(self):
        return [(p.stage, p.index, p) for p in self._places]

    def launch(self, handle, fn, config, resume_path, resume_seq):
        handle.launch_id += 1
        handle.ended, handle.pending = False, None
        place = {"stage": handle.stage, "index": handle.index,
                 "rank": handle.rank, "launch_id": handle.launch_id}
        ray_tpu.get(handle.actor.execute.remote(
            _start_on_worker, fn, config, place, self._name,
            self._sum_groups[handle.stage], resume_path, resume_seq),
            timeout=120)

    def results(self, timeout):
        polled = [p for p in self._places if not p.ended]
        for p in polled:
            if p.pending is None:
                p.pending = p.actor.execute.remote(
                    _drain_on_worker, p.launch_id, timeout)
        got = _gather([p.pending for p in polled], timeout + 2)
        out = []
        for p, r in zip(polled, got):
            # a call in flight when its actor died and is being restarted
            # never returns: ask the actor (the restarted process, or this
            # one after the drain) whether it still holds the session
            if isinstance(r, ray_tpu.GetTimeoutError) and self._holds_session(p):
                continue  # slow, not dead: the same drain is read next time
            p.pending = None
            if isinstance(r, Exception) or r.get("lost"):
                p.ended = True
                out.append((p, {"type": "error",
                                "error_type": "WorkerDiedError",
                                "error": f"stage {p.stage} worker {p.index}: "
                                         f"{r!r}"[:500], "error_path": ""}))
                continue
            for item in r["results"]:
                p.ended = p.ended or item["type"] != "report"
                out.append((p, item))
        return out

    @staticmethod
    def _holds_session(p) -> bool:
        try:
            return ray_tpu.get(p.actor.execute.remote(_has_session,
                                                      p.launch_id), timeout=10)
        except Exception:  # noqa: BLE001 — dead
            return False

    def quiesce(self, timeout):
        self._wait_restart_s = timeout
        got = _gather([p.actor.execute.remote(_quiesce_on_worker, timeout)
                       for p in self._places], timeout + 10)
        # a dead worker holds no loop: fit() respawns it next
        return [(p.stage, p.index) for p, r in zip(self._places, got)
                if isinstance(r, dict) and not r["ok"]]

    def alive(self, handle):
        return self._wgs[handle.stage].probe(indices=[handle.index])[0]

    def respawn(self, handle):
        wg = self._wgs[handle.stage]
        wg.heal(wait_restart_s=self._wait_restart_s)
        if wg.num_workers < self._sizes[handle.stage]:
            raise RuntimeError(f"stage {handle.stage}: respawn budget spent")
        for p in self._places:
            if p.stage == handle.stage:
                p.actor = wg.workers[p.index]

    def reform(self):
        """JAX's pipeline reform (ray_tpu/parallel/mpmd_pipeline.py
        ``_heal``): the p2p group spans every gang, so its epoch is bumped
        here; each sum group reforms through its WorkerGroup."""
        import msgpack

        from ray_tpu._private.api import _get_worker
        from ray_tpu.collective.collective import KV_NS, _epoch_key

        head = _get_worker().head
        key = _epoch_key(self._name)
        raw = head.call("kv_get", {"ns": KV_NS, "key": key})
        cur = msgpack.unpackb(raw) if raw is not None else 1
        live = _gather([p.actor.__ray_tpu_collective_epoch__.remote(self._name)
                        for p in self._places], 30)
        epoch = max([cur] + [e for e in live if isinstance(e, int)]) + 1
        head.call("kv_put", {"ns": KV_NS, "key": key,
                             "value": msgpack.packb(epoch)})
        ray_tpu.get([p.actor.__ray_tpu_reform_collective__.remote(
            len(self._places), p.rank, self._name, epoch)
            for p in self._places], timeout=120)
        for wg, group in zip(self._wgs, self._sum_groups):
            if group is not None:
                wg.reform_collective(group, timeout=120)
        return epoch

    def record(self, cat, name, t0, t1, attrs=None):
        self.spans.append((name, dict(attrs or {})))

    def shutdown(self):
        stuck = self.quiesce(10.0) if self._places else []
        for wg in self._wgs:
            wg.shutdown()
        self._wgs, self._places = [], []
        return stuck


# ---------------------------------------------------------------------------
# JAX's toy model (2 matmul stages) and sequential baseline
# ---------------------------------------------------------------------------

D0, D1, D2, B = 6, 5, 4, 8
LR = 0.05


def data_fn(step, m):
    rng = np.random.default_rng(1000 + step * 100 + m)
    return (rng.standard_normal((B, D0)), rng.standard_normal((B, D2)))


def init0(cfg):
    return {"w": np.random.default_rng(7).standard_normal((D0, D1))}


def init1(cfg):
    return {"w": np.random.default_rng(8).standard_normal((D1, D2))}


def fwd(params, x):
    return x @ params["w"], x


def bwd(params, x, dy):
    return dy @ params["w"].T, {"w": x.T @ dy}


def loss_fn(params, y, t):
    d = y - t
    return 0.5 * float(np.mean(d * d)), d / d.size


def baseline(steps, mbs):
    """Single-slice sequential reference: same math, no pipeline."""
    p0, p1 = init0({}), init1({})
    losses = []
    for step in range(steps):
        g0 = np.zeros_like(p0["w"])
        g1 = np.zeros_like(p1["w"])
        ls = []
        for m in range(mbs):
            x, t = data_fn(step, m)
            y0, s0 = fwd(p0, x)
            y1, s1 = fwd(p1, y0)
            loss, dy = loss_fn(p1, y1, t)
            ls.append(loss)
            dx1, gg1 = bwd(p1, s1, dy)
            _, gg0 = bwd(p0, s0, dx1)
            g0 += gg0["w"]
            g1 += gg1["w"]
        p0["w"] = p0["w"] - LR * g0 / mbs
        p1["w"] = p1["w"] - LR * g1 / mbs
        losses.append(sum(ls) / len(ls))
    return losses, p0, p1


def _port_fit(runtime, sizes=(1, 1), **kw):
    # JAX's pack_callable drops the by-value registration on exit
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    return MpmdPipeline([StageSpec(sizes[0], init0, fwd, bwd),
                         StageSpec(sizes[1], init1, fwd, bwd, loss_fn)],
                        data_fn=data_fn, lr=LR, runtime=runtime,
                        name=f"hosted-{uuid.uuid4().hex[:6]}", **kw).fit()


@pytest.mark.parametrize("schedule,steps", [("1f1b", 3), ("gpipe", 2)])
def test_hosted_pipeline_is_bit_equal_to_baseline(cluster, schedule, steps):
    rt = RayPipelineRuntime()
    with _time_limit(120):
        res = _port_fit(rt, num_steps=steps, microbatches=4,
                        schedule=schedule, return_params=True)
    bl, p0, p1 = baseline(steps, 4)
    assert res.steps_completed == steps
    assert res.heals == 0 and res.gang_restarts == 0
    assert res.stage_world_sizes == [1, 1]
    np.testing.assert_array_equal(res.losses, bl)
    np.testing.assert_array_equal(res.final_params[0]["w"], p0["w"])
    np.testing.assert_array_equal(res.final_params[1]["w"], p1["w"])
    assert sorted(res.bubble_by_stage) == [0, 1]
    assert all(0.0 <= b < 1.0 for b in res.bubble_by_stage.values())
    assert rt.spans == [] and rt._wgs == []


def test_hosted_pipeline_asymmetric_dp(cluster):
    rt = RayPipelineRuntime()
    with _time_limit(120):
        res = _port_fit(rt, sizes=(1, 2), num_steps=2, microbatches=4,
                        return_params=True)
    bl, p0, p1 = baseline(2, 4)
    assert res.stage_world_sizes == [1, 2]
    assert res.heals == 0 and res.gang_restarts == 0
    np.testing.assert_allclose(res.losses, bl, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.final_params[0]["w"], p0["w"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res.final_params[1]["w"], p1["w"], rtol=0,
                               atol=1e-12)


# tests/test_mpmd_pipeline.py:226-238: rank 1 exits at its 11th boundary
# (step 2's second microbatch)
KILL = [{"site": "pipeline.stage", "match": {"rank": 1}, "after": 10,
         "action": "exit", "count": 1}]
HEAL_KW = dict(num_steps=5, microbatches=4, ckpt_every=1, p2p_timeout_s=15.0,
               quiesce_timeout_s=5.0, poll_s=2.0, fault_specs=KILL)


def test_hosted_stage_kill_heals_in_place_like_jax(cluster, tmp_path):
    bl, _, _ = baseline(5, 4)
    rt = RayPipelineRuntime()
    with _time_limit(240):
        res = _port_fit(rt, ckpt_dir=str(tmp_path / "port"), **HEAL_KW)
        jres = JMpmdPipeline(
            [JStageSpec(1, init0, fwd, bwd),
             JStageSpec(1, init1, fwd, bwd, loss_fn)],
            data_fn=data_fn, lr=LR, ckpt_dir=str(tmp_path / "jax"),
            name=f"jhosted-{uuid.uuid4().hex[:6]}", **HEAL_KW).fit()
    assert res.heals >= 1, "the fault never fired or the heal never ran"
    assert res.gang_restarts == 0
    assert res.steps_completed == 5
    np.testing.assert_allclose(res.losses, bl, rtol=0, atol=0)
    heal = [a for name, a in rt.spans if name == "pipeline.heal"]
    assert heal, "the heal left no pipeline.heal record"
    assert heal[-1]["stages"] == [1]
    assert heal[-1]["epoch"] >= 2 and heal[-1]["resume_step"] >= 1
    # JAX's pipeline under the same script on the same cluster
    assert jres.steps_completed == 5
    assert res.losses == jres.losses
    assert (res.heals, res.gang_restarts) == (jres.heals, jres.gang_restarts)
