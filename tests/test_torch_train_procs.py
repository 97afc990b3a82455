"""The port's train gang in processes of its own (``ProcessTrainRuntime``,
``train/worker_group.py``) on the CPU.

Each train worker is a spawned process; their gradient sync is a socket
group of the port's collective, linked worker to worker, with JAX's
group epochs. The worker functions live in tests/process_members.py,
which a worker process imports.

- ``Trainer(backend="dcn")`` on the process gang runs
  tests/test_torch_train_hosted.py's numpy loop (a copy that arms the
  port's fault injection: worker 1 exits at its third allreduce, in the
  step in which JAX's ``ring.send`` kill trips) and gives JaxTrainer's
  metrics history and resume counts on a ray_tpu ``Cluster``, and the
  reference params;
- a rank the runtime restarts in place resumes in place; a wedged
  survivor falls back to a gang restart;
- the gang alone: a runtime restart keeps the identity and empties the
  state, a heal respawn gives a new identity, a heal with no budget
  shrinks, ``grow`` adds a fresh worker, and each reform bumps the epoch
  of every member;
- ``backend="torch"`` over gloo at world 2;
- the codecs bf16 and int8 give the in-process gang's bits;
- a member that dies during a reform's join aborts the others' joins
  with ``CollectiveAbortError`` within 10 s;
- ``shutdown`` leaves no process and no socket file.

Every get carries a timeout, and every test a time limit.
"""

import contextlib
import os
import signal
import stat
import sys
import threading
import time
import types

import cloudpickle
import numpy as np
import pytest
import torch

from ray_tpu._private import fault_injection as jfi
from ray_tpu.cluster_utils import Cluster
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu_torch import train
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.train.worker_group import (InProcessTrainRuntime,
                                              ProcessTrainRuntime)

import process_members as pm
import test_torch_train_hosted as hosted

STEPS = hosted.STEPS
# worker 1's third gradient allreduce: step 3, where JAX's KILL (the
# sixth ring.send: two a step at world 2) trips
PORT_KILL = [{"site": "collective.allreduce", "match": {"rank": 1},
              "after": 2, "count": 1, "action": "exit"}]


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


class _Spans:
    def __init__(self):
        self.spans = []
        self.lock = threading.Lock()

    def record(self, cat, name, t0, t1, attrs=None):
        with self.lock:
            self.spans.append((name, t0, t1, dict(attrs or {})))

    def named(self, name):
        return [s for s in self.spans if s[0] == name]


def _fit(tmp_path, runtime, specs=None, loop=pm.numpy_loop, max_restarts=0,
         quiesce=30.0, max_failures=1, **extra):
    config = {"steps": STEPS, "ck_dir": str(tmp_path / "ck"), "specs": specs,
              "kill_rank": 1, **extra}
    return train.Trainer(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(
            num_workers=2, backend="dcn", min_workers=1,
            max_restarts=max_restarts, device="cpu"),
        run_config=train.RunConfig(name="procs", storage_path=str(tmp_path / "p"),
                                   max_failures=max_failures,
                                   max_inplace_resumes=4,
                                   quiesce_timeout_s=quiesce),
        datasets={"train": list(range(pm.N_BLOCKS))}, runtime=runtime).fit()


def _assert_reference_params(result):
    np.testing.assert_allclose(result.checkpoint.to_dict()["params"],
                               hosted._ref_params(STEPS), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_resources={"CPU": 8, "memory": 4 * 2**30})
    c.connect()
    yield c
    c.shutdown()


def test_process_gang_matches_jax_trainer_under_one_fault_script(cluster,
                                                                 tmp_path):
    """JaxTrainer with JAX's kill and the port's Trainer on the process
    gang with the port's: equal histories and resume counts, the
    reference params, and the workers' step spans back in the driver."""
    with _time_limit(300):
        cloudpickle.register_pickle_by_value(sys.modules[hosted.__name__])
        jr = JaxTrainer(
            hosted._numpy_loop,
            train_loop_config=hosted._config("ray_tpu", tmp_path, hosted.KILL),
            scaling_config=JScalingConfig(num_workers=2,
                                          resources_per_worker={"CPU": 1},
                                          backend="dcn", min_workers=1,
                                          placement_strategy="PACK"),
            run_config=JRunConfig(name="jprocs", storage_path=str(tmp_path / "j"),
                                  max_failures=1, max_inplace_resumes=4),
            datasets={"train": list(range(pm.N_BLOCKS))}).fit()
        jfi.clear()
        spans = _Spans()
        pr = _fit(tmp_path, ProcessTrainRuntime(spans, device="cpu"), PORT_KILL)
    assert jr.error is None and pr.error is None, (jr.error, pr.error)
    assert pr.resumes == jr.resumes == {"inplace": 1, "gang": 0}
    assert pr.metrics_history == jr.metrics_history
    assert [m["step"] for m in pr.metrics_history] == list(range(1, STEPS + 1))
    _assert_reference_params(pr)
    killed = spans.named("worker.killed")
    assert len(killed) == 1 and killed[0][3]["exitcode"] == 1
    steps = [s[3] for s in spans.named("train.step")]
    assert {a["resume_seq"] for a in steps} == {0, 1}
    assert all(a["collective_wait_s"] > 0 for a in steps)
    assert [s[3]["mode"] for s in spans.named("train.resume")] == ["inplace"]
    # a worker's stamps are on the driver's clock: the first step of the
    # resumed run ends after the death was seen
    first = min(s[2] for s in spans.named("train.step")
                if s[3]["resume_seq"] == 1)
    assert first > killed[0][1]


def test_runtime_restarted_rank_resumes_in_place(tmp_path):
    """The runtime restarts worker 1's process in place (same identity,
    empty state): the heal waits for it, sees it empty, sets it up and
    ships its blocks."""
    with _time_limit(240):
        r = _fit(tmp_path, ProcessTrainRuntime(runtime_restarts=True,
                                               device="cpu"),
                 PORT_KILL, max_restarts=1)
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 1, "gang": 0}
    assert [m["step"] for m in r.metrics_history] == list(range(1, STEPS + 1))
    assert all(m["world"] == 2 for m in r.metrics_history)
    _assert_reference_params(r)


def test_wedged_survivor_falls_back_to_gang_restart(tmp_path):
    with _time_limit(240):
        r = _fit(tmp_path, ProcessTrainRuntime(device="cpu"), PORT_KILL,
                 max_restarts=1, quiesce=1.0, stubborn=True)
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 0, "gang": 1}
    assert [m["step"] for m in r.metrics_history] == list(range(1, STEPS + 1))
    _assert_reference_params(r)


def _sums(wg, name, value=1.0):
    return wg.execute(pm.worker_allreduce, name, value, timeout=60)


def _epochs(wg, name):
    return wg.execute(pm.worker_epoch, name, timeout=60)


def _gone(pids):
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


def test_runtime_restart_keeps_identity_then_heal_respawns_fresh():
    """A runtime restart: the same identity in a new process with an empty
    state, restarts counted; a second death stays dead, and the heal's
    respawn gives the place a new identity; each reform bumps every
    member's epoch."""
    with _time_limit(180):
        wg = ProcessTrainRuntime(runtime_restarts=True, device="cpu"
                                 ).worker_group(2, max_restarts=1)
        try:
            name = wg.init_collective()
            assert _epochs(wg, name) == [1, 1]
            w1 = wg.workers[1]
            ids, pid1 = [w._actor_id for w in wg.workers], w1.pid
            assert wg.get(wg.submit(w1, pm.worker_state, "x", 1), 30) == ["x"]
            wg.kill(w1)
            assert wg.heal(wait_restart_s=60) == 2  # waits for the restart
            assert wg.workers[1] is w1 and w1.restarts == 1
            assert w1._actor_id == ids[1] and w1.pid != pid1
            assert wg.get(wg.submit(w1, pm.worker_state), 30) == []
            wg.reform_collective()
            assert _epochs(wg, name) == [2, 2]
            assert [o["out"] for o in _sums(wg, name)] == [[2.0] * 4] * 2
            wg.kill(w1)  # its restarts are used: it stays dead
            assert wg.probe() == [True, False]
            assert wg.heal(wait_restart_s=5) == 2  # the gang's one respawn
            fresh = wg.workers[1]
            assert fresh is not w1 and fresh._actor_id not in ids
            assert fresh.worker_idx == 2 and fresh.restarts == 0
            wg.reform_collective()
            assert _epochs(wg, name) == [3, 3]
            assert [o["idx"] for o in _sums(wg, name, 2.0)] == [0, 2]
        finally:
            wg.shutdown()


def test_shrink_with_no_budget_then_grow_back():
    with _time_limit(180):
        wg = ProcessTrainRuntime(device="cpu").worker_group(3, max_restarts=0)
        try:
            name = wg.init_collective()
            assert [o["out"] for o in _sums(wg, name)] == [[3.0] * 4] * 3
            survivors = [wg.workers[0].pid, wg.workers[2].pid]
            wg.kill(wg.workers[1])
            assert wg.probe() == [True, False, True]
            assert wg.heal() == 2  # no respawn budget: shrink
            assert [w.pid for w in wg.workers] == survivors
            wg.reform_collective()
            assert _epochs(wg, name) == [2, 2]
            assert [o["out"] for o in _sums(wg, name)] == [[2.0] * 4] * 2
            assert wg.grow(3) == 3
            assert [w.worker_idx for w in wg.workers] == [0, 2, 3]
            wg.reform_collective()
            outs = _sums(wg, name)
            assert [o["out"] for o in outs] == [[3.0] * 4] * 3
            assert [o["pid"] for o in outs[:2]] == survivors
            assert _epochs(wg, name) == [3, 3, 3]
            with pytest.raises(ValueError, match="started with 3"):
                wg.grow(4)
        finally:
            wg.shutdown()


def test_torch_backend_over_gloo_at_world_two(tmp_path):
    with _time_limit(180):
        r = train.Trainer(
            pm.gloo_loop, scaling_config=train.ScalingConfig(
                num_workers=2, backend="torch", device="cpu"),
            run_config=train.RunConfig(storage_path=str(tmp_path)),
            runtime=ProcessTrainRuntime(device="cpu")).fit()
    assert r.error is None, r.error
    assert r.metrics == {"world": 2, "rank": 0, "sum": [3.0] * 4,
                         "backend": "gloo", "group": None}


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_codecs_equal_the_in_process_gang(tmp_path, codec):
    with _time_limit(240):
        procs = _fit(tmp_path / "procs", ProcessTrainRuntime(device="cpu"),
                     codec=codec)
        local = _fit(tmp_path / "local", InProcessTrainRuntime(), codec=codec)
    assert procs.error is None and local.error is None
    assert procs.metrics_history == local.metrics_history
    a = procs.checkpoint.to_dict()["params"]
    b = local.checkpoint.to_dict()["params"]
    assert a.tobytes() == b.tobytes()
    # lossy, but close to the uncompressed reference
    np.testing.assert_allclose(a, hosted._ref_params(STEPS), rtol=2e-2,
                               atol=2e-2)


def _listening(address) -> bool:
    """Whether an AF_UNIX address is bound: a socket file, or a name in
    Linux's abstract namespace (listed in /proc/net/unix)."""
    if not address.startswith("\0"):
        return os.path.exists(address) and stat.S_ISSOCK(
            os.stat(address).st_mode)
    with open("/proc/net/unix") as f:
        return any(line.rstrip().endswith("@" + address[1:]) for line in f)


def _epoch_addresses(wg, epoch, world):
    return col.socket_addresses(wg._rt._root, f"{wg._token}e{epoch}", world)


def _wait_for(pred, seconds):
    deadline = time.monotonic() + seconds
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def test_a_death_during_a_reform_join_aborts_the_others_within_10s():
    """Worker 2 is stopped (SIGSTOP) when the reform starts: workers 0 and
    1 enter the join of epoch 2 and wait for it. It is then killed: the
    driver sees the death and aborts their joins, which raise
    CollectiveAbortError (the reform raises it) within 10 s; the
    survivors then shrink, reform and sync."""
    with _time_limit(180):
        wg = ProcessTrainRuntime(device="cpu").worker_group(3)
        try:
            name = wg.init_collective()
            victim = wg.workers[2]
            os.kill(victim.pid, signal.SIGSTOP)
            errs = []

            def reform():
                try:
                    wg.reform_collective(timeout=120)
                except BaseException as e:  # noqa: BLE001 — checked below
                    errs.append((e, time.monotonic()))

            th = threading.Thread(target=reform, daemon=True)
            th.start()
            # both survivors listen on epoch 2's sockets: they are joining
            joining = _epoch_addresses(wg, 2, 3)[:2]
            assert _wait_for(lambda: all(map(_listening, joining)), 30)
            t0 = time.monotonic()
            os.kill(victim.pid, signal.SIGKILL)
            th.join(30)
            assert not th.is_alive()
            err, t1 = errs[0]
            assert isinstance(err, col.CollectiveAbortError), err
            assert t1 - t0 < 10
            assert (err.group, err.epoch, err.op) == (name, 2, "join")
            assert err.rank in (0, 1)
            assert wg.heal() == 2
            wg.reform_collective()
            assert _epochs(wg, name) == [3, 3]
            assert [o["out"] for o in _sums(wg, name)] == [[2.0] * 4] * 2
        finally:
            wg.shutdown()


def test_shutdown_leaves_no_process_and_no_socket_file():
    with _time_limit(120):
        wg = ProcessTrainRuntime(device="cpu").worker_group(2)
        name = wg.init_collective()
        _sums(wg, name)
        root = wg._rt._root
        socks = _epoch_addresses(wg, 1, 2)
        assert all(map(_listening, socks))
        members = [w.member for w in wg.workers]
        assert wg.shutdown() == [] and wg.workers == []
        assert not os.path.exists(root)
        assert not any(map(_listening, socks))
        assert all(m.process.exitcode is not None for m in members)
        assert _gone([m.pid for m in members])


def test_a_cuda_worker_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with _time_limit(120):
        with pytest.raises(RuntimeError, match="sees no card"):
            ProcessTrainRuntime().worker_group(1)


def test_nccl_needs_a_card_per_rank():
    from ray_tpu_torch.train import backend_executor as tbe

    w = types.SimpleNamespace(worker_idx=0, state={})
    with pytest.raises(RuntimeError, match="card per rank"):
        tbe._setup_backend(w, "127.0.0.1:1", torch.cuda.device_count() + 1,
                           "cuda")
