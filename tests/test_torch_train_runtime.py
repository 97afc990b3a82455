"""The port's train runtime against the JAX package's, with no cluster.

The cluster-free cases of tests/test_train_elastic.py run on the same
inputs through the JAX function and the port's: ``_drain``'s per-rank
buffering and typed failures, ``_shutdown_quietly``, the ``DataShard``
cursor, the executor's rebalance, and a warm resume without a
checkpoint. Then ``Trainer.fit`` on the in-process gang on the CPU,
training the port's MLP classifier with two workers synced by
``dcn_allreduce_grads``, rank 0 saving the train state every step
(``save_state``, the data cursor beside it): it runs to completion; a
rank death resumes in place with the uninterrupted run's losses, bit
for bit; a survivor that will not quiesce falls back to a gang restart;
a rank the runtime restarts in place is set up again as a fresh member;
a torn checkpoint falls back to the one before it. The ``"torch"``
backend runs at world size 1 in-process and is refused above it.
"""

import gc
import os
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch

from ray_tpu._private import serialization as jser
from ray_tpu.train import CheckpointManager as JCheckpointManager
from ray_tpu.train import JaxTrainer
from ray_tpu.train import backend_executor as jbe
from ray_tpu.train.session import DataShard as JDataShard
from ray_tpu_torch import train
from ray_tpu_torch.models import mlp
from ray_tpu_torch.train import backend_executor as tbe
from ray_tpu_torch.train import fault_injection, session
from ray_tpu_torch.train.session import DataShard
from ray_tpu_torch.train.worker_group import InProcessTrainRuntime

# ---------------------------------------------------------------------------
# _drain and _shutdown_quietly, the same rounds through both packages
# ---------------------------------------------------------------------------


class _FakeExec:
    def __init__(self, rounds):
        self.num_workers = len(rounds[0])
        self._it = iter(rounds)

    def next_results(self, timeout=10.0):
        return next(self._it)


def _rep(step, rank):
    return {"type": "report", "metrics": {"step": step, "src_rank": rank}}


DRAIN_CASES = {
    "buffers_reports_per_rank": [
        [_rep(1, 0), {"type": "pending"}],
        [_rep(2, 0), _rep(1, 1)],
        [{"type": "finished"}, _rep(2, 1)],
        [{"type": "finished"}, {"type": "finished"}]],
    "unequal_results_is_error": [
        [_rep(1, 0), {"type": "finished"}],
        [{"type": "finished"}, {"type": "finished"}]],
    "prefers_typed_abort_over_generic_death": [[
        {"type": "error", "error": "tb...", "error_type": "CollectiveAbortError"},
        {"type": "dead", "error": "RayActorError: actor died"}]],
    "death_alone_synthesizes_worker_died": [[
        {"type": "pending"}, {"type": "dead", "error": "RayActorError: gone"}]],
    "corrupt_path_from_any_rank": [[
        {"type": "error", "error": "tb", "error_type": "CollectiveAbortError"},
        {"type": "error", "error": "tb", "error_type": "CheckpointCorruptError",
         "error_path": "/ck/7"}]],
}


def _drain(trainer, mgr_cls, rounds, tmp_path):
    history = []
    try:
        final = trainer._drain(_FakeExec(rounds), mgr_cls(str(tmp_path)), history)
        return {"final": final, "history": history}
    except RuntimeError as e:
        return {"error": type(e).__name__, "msg": str(e).split(":")[0],
                "error_type": getattr(e, "error_type", None),
                "error_path": getattr(e, "error_path", None),
                "dead_ranks": getattr(e, "dead_ranks", None),
                "history": history}


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_matches_jax(case, tmp_path):
    rounds = DRAIN_CASES[case]
    want = _drain(JaxTrainer(lambda c: None), JCheckpointManager, rounds,
                  tmp_path / "j")
    got = _drain(train.Trainer(lambda c: None), train.CheckpointManager, rounds,
                 tmp_path / "t")
    assert got == want
    if case == "buffers_reports_per_rank":
        assert [m["step"] for m in got["history"]] == [1, 2]


def test_drain_records_the_failing_rounds_reports(tmp_path):
    """A step completed in the round of a death keeps its checkpoint (the
    port records the round's reports before it raises; JAX loses them)."""
    ckpt = train.Checkpoint(str(tmp_path / "c"))
    rounds = [[_rep(1, 0), {"type": "pending"}],
              [{"type": "pending"}, {**_rep(1, 1), "checkpoint": ckpt}],
              [_rep(2, 0), {"type": "dead", "error": "gone"}]]
    rounds[1][1]["checkpoint"] = ckpt
    mgr = train.CheckpointManager(str(tmp_path / "m"))
    history = []
    with pytest.raises(tbe.TrainingFailedError):
        train.Trainer(lambda c: None)._drain(_FakeExec(rounds), mgr, history)
    assert [m["step"] for m in history] == [1]
    assert mgr.latest.path == ckpt.path


@pytest.mark.parametrize("trainer_cls", [JaxTrainer, train.Trainer],
                         ids=["jax", "port"])
def test_shutdown_quietly_never_masks_the_failure(trainer_cls):
    class _Boom:
        def shutdown(self):
            raise RuntimeError("agent connection lost during teardown")

    trainer_cls._shutdown_quietly(_Boom())
    trainer_cls._shutdown_quietly(None)


# ---------------------------------------------------------------------------
# DataShard cursors: the same operations on both packages' shards
# ---------------------------------------------------------------------------


def _epoch_and_cursor(cls):
    sh = cls("t", [f"b{i}" for i in range(6)], [0, 2, 4])
    out = [list(sh), sh.epoch, sh.state()]
    it = iter(sh)
    out += [next(it), sh.state()]
    return out


def _reassign_keeps_cursor(cls):
    sh = cls("t", list(range(8)), [0, 1, 2])
    it = iter(sh)
    next(it), next(it)
    sh.reassign([0, 1, 2, 5, 7])
    out = [sh.state(), list(sh), sh.epoch]
    it = iter(sh)
    next(it)
    sh.reassign([1, 2])
    return out + [sh.state(), sorted(sh.assigned_indices())]


def _cursor_roundtrip(cls):
    sh = cls("t", list(range(6)), [0, 1, 2, 3])
    it = iter(sh)
    next(it)
    snap = sh.state()
    next(it), next(it)
    sh.load_state(snap)
    out = [list(sh)]
    sh.load_state({"epoch": 3, "consumed": [0, 5]})
    return out + [sh.state()]


def _break_keeps_epoch(cls):
    sh = cls("t", list(range(4)), [0, 1, 2, 3])
    for b in sh:
        if b == 1:
            break
    out = [sh.epoch, sh.state()]
    return out + [list(sh), sh.epoch]


def _empty_assignment(cls):
    sh = cls("t", list(range(4)), [])
    return [list(sh), sh.epoch, list(sh), sh.epoch, len(sh)]


SHARD_CASES = {f.__name__[1:]: f for f in (
    _epoch_and_cursor, _reassign_keeps_cursor, _cursor_roundtrip,
    _break_keeps_epoch, _empty_assignment)}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_datashard_matches_jax(case):
    got = SHARD_CASES[case](DataShard)
    assert got == SHARD_CASES[case](JDataShard)
    if case == "epoch_and_cursor":
        assert got == [["b0", "b2", "b4"], 1, {"epoch": 1, "consumed": []}, "b0",
                       {"epoch": 1, "consumed": [0]}]


# ---------------------------------------------------------------------------
# the executor's rebalance and warm resume
# ---------------------------------------------------------------------------


class _FakeHandle:
    def __init__(self, aid):
        self._actor_id = aid


REBALANCE_CASES = {
    # shrink then grow: every block assigned, the regrown worker levelled in
    "levels_regrown_worker": (4, {b"a": [0, 1], b"b": [2, 3]}, [b"a", b"b", b"c"]),
    # a same-size replacement re-adopts its dead predecessor's blocks
    "orphans_prefer_fresh_member": (
        7, {b"a": [0, 1], b"b": [2, 3], b"dead": [4, 5, 6]}, [b"a", b"b", b"c"]),
    "shrink_spreads_orphans": (
        9, {b"a": [0, 3, 6], b"b": [1, 4, 7], b"c": [2, 5, 8]}, [b"a", b"c"]),
    "grow_two": (10, {b"a": list(range(10))}, [b"a", b"b", b"c"]),
}


def _rebalanced(ex, n_blocks, before, ids):
    ex.worker_group = types.SimpleNamespace(workers=[_FakeHandle(a) for a in ids])
    ex._assignments = {"train": {k: list(v) for k, v in before.items()}}
    ex._rebalance_assignments()
    return ex._assignments["train"]


@pytest.mark.parametrize("case", sorted(REBALANCE_CASES))
def test_rebalance_matches_jax(case):
    n_blocks, before, ids = REBALANCE_CASES[case]
    datasets = {"train": list(range(n_blocks))}
    want = _rebalanced(jbe.BackendExecutor(3, backend="dcn", datasets=datasets),
                       n_blocks, before, ids)
    got = _rebalanced(tbe.BackendExecutor(3, backend="dcn", datasets=datasets),
                      n_blocks, before, ids)
    assert got == want
    assert sorted(i for v in got.values() for i in v) == list(range(n_blocks))


def _warm_resume(start, make_fn, resume_path):
    w = types.SimpleNamespace(worker_idx=0, state={})
    sh_cls = JDataShard if start is jbe._start_training else DataShard
    sh = sh_cls("train", list(range(4)), [0, 1])
    next(iter(sh))
    w.state["dataset_shards"] = {"train": sh}
    start(w, make_fn(), {}, resume_path, rank=0, world_size=1,
          shard_plan={"train": (None, [0, 1])}, resume_seq=1)
    w.state["train_thread"].join(5)
    return sh.epoch, sorted(sh._consumed)


@pytest.mark.parametrize("resume_path", [None, "/nonexistent-but-unused"],
                         ids=["no_checkpoint", "checkpoint"])
def test_warm_resume_cursor_matches_jax(resume_path):
    """Without a checkpoint the model restarts, so the cursors restart;
    with one they are kept."""
    want = _warm_resume(jbe._start_training,
                        lambda: jser.pack_callable(lambda cfg: None), resume_path)
    got = _warm_resume(tbe._start_training, lambda: (lambda cfg: None),
                       resume_path)
    assert got == want == ((0, []) if resume_path is None else (0, [0]))


def test_torch_backend_needs_processes():
    with pytest.raises(ValueError, match="process per worker"):
        tbe.BackendExecutor(2, backend="torch")
    with pytest.raises(ValueError, match="'torch' or 'dcn'"):
        tbe.BackendExecutor(1, backend="jax")


# ---------------------------------------------------------------------------
# Trainer.fit on the in-process gang: the MLP classifier, two workers
# ---------------------------------------------------------------------------

N_BLOCKS, STEPS, WORLD = 8, 6, 2
CFG = mlp.MLPConfig(d_in=8, d_hidden=16, n_hidden=1, d_out=4)


# The workers are threads, and the CPU's torch ops run in both at once.
# Under load, the same step on the same tensors once gave a loss 1.1e-5
# off (2 of 96 first steps, torch 2.13 on the CPU): concurrent CPU kernels
# are not reliably bit-reproducible. The losses are compared bit for bit,
# so the workers take turns at the arithmetic and overlap only in the
# gradient sync (on the card each worker has a stream of its own).
_CPU_TURN = threading.Lock()


def _in_turn_sync(group):
    def sync(grads):
        _CPU_TURN.release()
        try:
            return train.dcn_allreduce_grads(grads, group)
        finally:
            _CPU_TURN.acquire()
    return sync


def _blocks():
    out = []
    for i in range(N_BLOCKS):
        r = np.random.RandomState(100 + i)
        out.append({"x": torch.from_numpy(r.randn(4, 8).astype(np.float32)),
                    "y": torch.from_numpy(r.randint(0, 4, 4))})
    return out


def _mlp_loop(config):
    """Each worker trains the MLP on its shard, syncs the gradients and the
    consumed blocks, and rank 0 saves the state with the cursor beside it.
    Faults arm on the first incarnation only."""
    rank, seq = session.get_world_rank(), session.get_resume_seq()
    if seq == 0 and config.get("specs") and rank == config.get("fault_rank"):
        fault_injection.configure(config["specs"])
    opt = train.fused_adamw(1e-2)
    state = train.init_train_state(
        lambda dev: mlp.init_params(CFG, torch.Generator().manual_seed(0), dev),
        opt, device="cpu")
    group = session.get_collective_group()
    step = train.make_train_step(
        lambda p, b: mlp.loss_fn(p, b, CFG), opt, device="cpu",
        sync_grads=_in_turn_sync(group))
    shard = session.get_dataset_shard("train")
    ck = session.get_checkpoint()
    if ck is not None:
        state = train.restore_state(ck.path, like=state)
        shard.load_state(ck.to_dict()["cursor"])
    blocks = [iter(shard)]

    def next_block():
        while True:
            try:
                return next(blocks[0])
            except StopIteration:
                blocks[0] = iter(shard)

    while state.step < config["steps"]:
        with _CPU_TURN:
            state, metrics = step(state, next_block())
        onehot = np.zeros(N_BLOCKS, np.float32)
        onehot[shard.state()["consumed"]] = 1
        union = train.dcn_allreduce_grads({"c": onehot}, group, op="sum")["c"]
        ckpt = None
        if rank == 0 and state.step <= config.get("save_until", STEPS):
            ckpt = train.save_state(
                state, os.path.join(config["ck"], f"s{seq}_{state.step}"),
                extra={"cursor": {"epoch": shard.epoch, "consumed": [
                    int(i) for i in np.nonzero(union)[0]]}})
        session.report({"step": state.step, "loss": float(metrics["loss"]),
                        "w0": float(state.params["layer0"]["w"][0, 0])},
                       checkpoint=ckpt)
        if config.get("stubborn") and seq == 0 and rank == 0 and state.step == 2:
            try:
                train.dcn_allreduce_grads({"g": np.ones(2, np.float32)}, group)
            except Exception:  # noqa: BLE001 — wedged: swallows the abort
                # past the trainer's 15 s result poll and the 1 s quiesce,
                # however the rounds fall (under 10 s of shutdown join)
                time.sleep(24.0)
                raise


def _fit(tmp_path, specs=None, fault_rank=1, runtime=None, quiesce=30.0,
         max_restarts=1, max_failures=1, **extra):
    fault_injection.clear()
    try:
        trainer = train.Trainer(
            _mlp_loop,
            train_loop_config={"steps": STEPS, "ck": str(tmp_path / "ck"),
                               "specs": specs, "fault_rank": fault_rank, **extra},
            scaling_config=train.ScalingConfig(num_workers=WORLD, backend="dcn",
                                               max_restarts=max_restarts,
                                               device="cpu"),
            run_config=train.RunConfig(storage_path=str(tmp_path),
                                       max_failures=max_failures,
                                       quiesce_timeout_s=quiesce),
            datasets={"train": _blocks()}, runtime=runtime)
        return trainer.fit()
    finally:
        fault_injection.clear()


def _by_step(result):
    """{step: loss}: a re-run step (after a fallback) overwrites the first."""
    return {m["step"]: (m["loss"], m["w0"]) for m in result.metrics_history}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return _fit(tmp_path_factory.mktemp("ref"))


def test_fit_runs_to_completion(uninterrupted):
    r = uninterrupted
    assert r.error is None and r.resumes == {"inplace": 0, "gang": 0}
    assert [m["step"] for m in r.metrics_history] == list(range(1, STEPS + 1))
    assert all(np.isfinite(m["loss"]) for m in r.metrics_history)
    got = train.restore_state(r.checkpoint.path, device="cpu")
    assert got.step == STEPS and got.opt_state.count == STEPS


KILL = [{"site": "collective.allreduce", "match": {"rank": 1}, "after": 4,
         "count": 1, "action": "exit"}]


def test_rank_death_resumes_in_place_with_the_same_losses(tmp_path, uninterrupted):
    spans = []
    rt = InProcessTrainRuntime(types.SimpleNamespace(
        record=lambda *a: spans.append(a)))
    r = _fit(tmp_path, KILL, runtime=rt)
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 1, "gang": 0}
    assert _by_step(r) == _by_step(uninterrupted)
    names = [s[1] for s in spans]
    assert "worker.killed" in names
    assert [s[4]["mode"] for s in spans if s[1] == "train.resume"] == ["inplace"]
    steps = [s[4] for s in spans if s[1] == "train.step"]
    assert {a["resume_seq"] for a in steps} == {0, 1}
    assert all(a["collective_wait_s"] > 0 for a in steps)


def test_wedged_survivor_falls_back_to_gang_restart(tmp_path, uninterrupted):
    r = _fit(tmp_path, KILL, quiesce=1.0, stubborn=True)
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 0, "gang": 1}
    assert _by_step(r) == _by_step(uninterrupted)


def test_runtime_restarted_rank_resumes_in_place(tmp_path, uninterrupted):
    """The runtime restarts the dead rank in place (same identity, empty
    state): the heal must see it is empty, set it up and ship its blocks."""
    r = _fit(tmp_path, KILL, runtime=InProcessTrainRuntime(runtime_restarts=True))
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 1, "gang": 0}
    assert _by_step(r) == _by_step(uninterrupted)


def test_torn_checkpoint_falls_back_to_the_previous(tmp_path, uninterrupted):
    """Rank 0 saves after steps 1-3, and the step-3 shard archive is torn;
    rank 1 dies in step 5, when step 3's reports must have reached the
    trainer (rank 1 got past its step-4 report, rank 0 past its step-4
    cursor sync). The restore of step 3 fails its crc: the trainer
    discards it and resumes again, from step 2."""
    specs = [{"site": "checkpoint.save", "match": {"file": "shards_p0.npz"},
              "after": 2, "count": 1, "action": "drop"},
             {"site": "collective.allreduce", "match": {"rank": 1}, "after": 8,
              "count": 1, "action": "exit"}]
    r = _fit(tmp_path, specs, fault_rank=0, save_until=3)
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 2, "gang": 0}
    assert _by_step(r) == _by_step(uninterrupted)


def test_user_error_propagates(tmp_path):
    def bad(config):
        raise KeyError("user bug")

    trainer = train.Trainer(bad, scaling_config=train.ScalingConfig(
        num_workers=2, backend="dcn", device="cpu"),
        run_config=train.RunConfig(storage_path=str(tmp_path), max_failures=1))
    with pytest.raises(tbe.TrainingFailedError) as ei:
        trainer.fit()
    assert ei.value.error_type == "KeyError"


def test_dead_loop_frees_what_its_closures_captured(tmp_path):
    """A loop that failed holds none of its tensors once it has ended,
    not even through a closure that captured one (a frame, even cleared,
    holds its function): the error keeps its traceback as text only."""
    refs = []

    def loop(config):
        state = torch.zeros(4)
        refs.append(weakref.ref(state))

        def sync():
            raise ValueError(f"sync failed at {float(state.sum())}")

        sync()

    gc.collect()
    gc.disable()
    try:
        with pytest.raises(tbe.TrainingFailedError) as ei:
            train.Trainer(loop, scaling_config=train.ScalingConfig(
                num_workers=2, backend="dcn", device="cpu"),
                run_config=train.RunConfig(storage_path=str(tmp_path),
                                           max_failures=0)).fit()
        assert len(refs) == 2 and all(r() is None for r in refs)
    finally:
        gc.enable()
    assert ei.value.error_type == "ValueError"
    assert "in sync" in str(ei.value) and "sync failed at 0.0" in str(ei.value)


def test_torch_backend_at_world_one(tmp_path):
    def loop(config):
        import torch.distributed as dist

        t = torch.ones(3)
        dist.all_reduce(t)
        session.report({"world": dist.get_world_size(), "sum": float(t.sum()),
                        "group": session.get_collective_group()})

    r = train.Trainer(loop, scaling_config=train.ScalingConfig(
        num_workers=1, backend="torch", device="cpu"),
        run_config=train.RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None
    assert r.metrics == {"world": 1, "sum": 3.0, "group": None}


# ---------------------------------------------------------------------------
# fault specs: the calls that trip, against the JAX package's harness
# ---------------------------------------------------------------------------

FAULT_SPECS = {
    "first_match": [{"site": "s", "match": {"rank": 1}, "action": "drop"}],
    "after_count": [{"site": "s", "after": 2, "count": 3, "action": "drop"}],
    "count_all": [{"site": "s", "match": {"rank": 0}, "after": 1, "count": 0,
                   "action": "drop"}],
    "two_specs": [{"site": "s", "match": {"rank": 0}, "count": 2, "action": "drop"},
                  {"site": "s", "after": 1, "count": 2, "action": "drop"}],
}


@pytest.mark.parametrize("case", sorted(FAULT_SPECS))
def test_fault_specs_trip_where_jax_does(case):
    """The process-wide harness and the per-session rule that the
    pipeline runtime applies (prepare + matches) trip at the same calls
    as JAX's configure + fire."""
    from ray_tpu._private import fault_injection as jfi

    calls = [("s", {"rank": i % 2, "step": i}) for i in range(10)] + [("t", {})]
    jfi.configure(FAULT_SPECS[case])
    try:
        want = [jfi.fire(site, **ctx) for site, ctx in calls]
    finally:
        jfi.clear()
    fault_injection.configure(FAULT_SPECS[case])
    try:
        got = [fault_injection.fire(site, **ctx) for site, ctx in calls]
    finally:
        fault_injection.clear()
    specs = fault_injection.prepare(FAULT_SPECS[case])
    per_session = [next((s["action"] for s in specs
                         if fault_injection.matches(s, site, ctx)), None)
                   for site, ctx in calls]
    assert got == per_session == want
    assert "drop" in want


# ---------------------------------------------------------------------------
# the in-process gang: runtime restarts, heal, shutdown
# ---------------------------------------------------------------------------


def test_gang_restart_heal_and_shutdown():
    """A runtime restart keeps the worker's identity and empties its
    state; a heal respawn gives the place a new identity while the
    budget lasts, then the gang shrinks; a call of an earlier
    incarnation raises the actor error; shutdown joins the loop
    threads."""
    wg = InProcessTrainRuntime(runtime_restarts=True).worker_group(
        3, max_restarts=1)
    wg.init_collective()
    ids = [w._actor_id for w in wg.workers]
    w1 = wg.workers[1]
    w1.state["x"] = 1
    release = threading.Event()
    stale = wg.submit(w1, lambda w: release.wait(5))
    wg.kill(w1)  # restarted in place by the runtime
    release.set()
    with pytest.raises(wg.actor_error):
        wg.get(stale, 5)
    assert wg.probe() == [True, True, True]
    assert w1._actor_id == ids[1] and w1.state == {} and w1.restarts == 1
    wg.kill(w1)  # its restarts are used: it stays dead
    assert wg.probe() == [True, False, True]
    assert wg.heal() == 3  # the gang's one respawn: a new worker there
    assert wg.workers[1] is w1 and w1._actor_id not in ids
    assert w1.restarts == 0 and w1.state == {}
    assert wg.get(wg.submit(w1, lambda w: w.worker_idx), 5) == 3
    wg.kill(wg.workers[2])
    wg.kill(wg.workers[2])  # restarted once, then dead for good
    assert wg.heal() == 2  # no respawn left: shrink
    assert [w._actor_id for w in wg.workers] == [ids[0], w1._actor_id]
    wg.reform_collective()
    assert wg._epoch.epoch == 2 and wg.collective_ranks == [0, 1]
    members, stop = list(wg.workers), threading.Event()
    for w in members:
        w.start_thread(stop.wait)
    assert wg.shutdown(timeout=0.2) == members  # wedged loops are named
    stop.set()
    for w in members:
        w.thread.join(5)
        assert not w.thread.is_alive()
