"""The ray_tpu runtime hosts the port's Trainer on its own actors.

The port's ``BackendExecutor`` takes its gang from a runtime value; here
it is built from ray_tpu's ``WorkerGroup`` (one actor process per
worker), with ray_tpu's ring collective as each worker's ``allreduce``
(codecs go to the ring), ``abort_all_local`` as its abort and the actor's
host address for the torch backend's rendezvous. A fault is a real
process exit (ray_tpu's fault site ``ring.send``, action ``exit``).

- ``backend="dcn"`` at world 2: a rank's death resumes in place;
- the same numpy-only loop, written once over either package's train
  modules, under one fault script, gives JaxTrainer's metrics history
  and resume counts;
- ``backend="torch"`` at world 2: one gloo process group over the two
  actor processes.
"""

import contextlib
import importlib
import signal
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu._private import fault_injection as jfi
from ray_tpu.cluster_utils import Cluster
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu.train.worker_group import WorkerGroup
from ray_tpu_torch import train

# worker processes cannot import the tests directory: ship by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

N_BLOCKS, DIM, LR, STEPS = 8, 16, 0.1, 6


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


class _Member:
    """The worker side of the runtime over a ray_tpu TrainWorker actor."""

    def __init__(self, actor):
        self.worker_idx = actor.worker_idx
        self.state = actor.state
        from ray_tpu._private.api import _get_worker

        self.addr = _get_worker().addr

    def allreduce(self, tensor, group_name, op="sum", *, codec=None,
                  transport=None, timeout=None, ef_tag=None, out=None):
        from ray_tpu.collective import collective as col

        res = torch.from_numpy(np.asarray(col.allreduce(
            tensor.numpy(), group_name, op, codec=codec, transport=transport,
            timeout=timeout, ef_tag=ef_tag)))
        if out is None or out.dtype != res.dtype:
            return res
        return out.copy_(res.reshape(out.shape))

    def abort_collectives(self, reason=""):
        from ray_tpu.collective import collective as col

        col.abort_all_local(reason)

    def record(self, cat, name, t0, t1, attrs=None):
        from ray_tpu._private import flight_recorder

        flight_recorder.record(cat, name, t0, t1, attrs=attrs)


def _on_member(actor, fn, *args, **kwargs):
    return fn(_Member(actor), *args, **kwargs)


class RayWorkerGroup:
    """A gang of the port's runtime interface over ray_tpu's WorkerGroup."""

    actor_error = ray_tpu.RayActorError
    processes = True

    def __init__(self, num_workers, resources_per_worker, strategy,
                 max_restarts):
        self.wg = WorkerGroup(num_workers, resources_per_worker=resources_per_worker,
                              strategy=strategy, max_restarts=max_restarts)

    @property
    def workers(self):
        return self.wg.workers

    @property
    def num_workers(self):
        return self.wg.num_workers

    def submit(self, w, fn, *args, **kwargs):
        return w.execute.remote(_on_member, fn, *args, **kwargs)

    def get(self, refs, timeout=None):
        return ray_tpu.get(refs, timeout=timeout)

    def execute(self, fn, *args, timeout=600.0, **kwargs):
        return self.get([self.submit(w, fn, *args, **kwargs)
                         for w in self.workers], timeout)

    def execute_single(self, idx, fn, *args, **kwargs):
        return self.get(self.submit(self.workers[idx], fn, *args, **kwargs), 600)

    def probe(self, timeout=5.0, indices=None):
        return self.wg.probe(timeout=timeout, indices=indices)

    def heal(self, *, wait_restart_s=60.0, respawn=True):
        return self.wg.heal(wait_restart_s=wait_restart_s, respawn=respawn)

    def grow(self, num_workers, timeout=60.0):
        return self.wg.grow(num_workers, timeout=timeout)

    def init_collective(self, group_name=None, **_):
        return self.wg.init_collective(group_name)

    def reform_collective(self, group_name=None, timeout=120.0, **_):
        return self.wg.reform_collective(group_name, timeout=timeout)

    def destroy_collective(self):
        self.wg.destroy_collective()

    def shutdown(self):
        self.wg.shutdown()


class RayTrainRuntime:
    processes = True
    errors = (ray_tpu.RayActorError, ray_tpu.GetTimeoutError)

    def __init__(self):
        self.spans = []

    def worker_group(self, num_workers, *, resources_per_worker=None,
                     strategy="SPREAD", max_restarts=0):
        return RayWorkerGroup(num_workers, resources_per_worker, strategy,
                              max_restarts)

    def record(self, cat, name, t0, t1, attrs=None):
        self.spans.append((name, dict(attrs or {})))


# ---------------------------------------------------------------------------
# one numpy-only loop over either package
# ---------------------------------------------------------------------------


def _block_grad(i, step):
    rng = np.random.default_rng(7919 * (i + 1) + step)
    return rng.standard_normal(DIM).astype(np.float32)


def _numpy_loop(config):
    """tests/test_train_elastic.py's loop, over config["pkg"]'s train
    modules: each step sums its shard's block gradients, syncs the total
    with dcn_allreduce_grads, and rank 0 checkpoints a dict. The fault
    spec arms on the first incarnation of its rank only."""
    import os as _os

    import numpy as _np

    from ray_tpu._private import fault_injection as _fi

    pkg = config["pkg"]
    tr = importlib.import_module(f"{pkg}.train")
    session = importlib.import_module(f"{pkg}.train.session")
    rank, seq = session.get_world_rank(), session.get_resume_seq()
    if seq == 0 and config.get("specs") and rank == config.get("kill_rank"):
        _fi.configure(config["specs"])
    shard = session.get_dataset_shard("train")
    group = session.get_collective_group()
    params = _np.zeros(DIM, _np.float32)
    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        d = ck.to_dict()
        params = _np.asarray(d["params"], _np.float32)
        start = int(d["step"])
    for step in range(start, config["steps"]):
        for _block in shard:
            pass
        contrib = _np.zeros(DIM, _np.float32)
        for i in shard.assigned_indices():
            contrib = contrib + _block_grad(i, step)
        total = tr.dcn_allreduce_grads({"g": contrib}, group, op="sum",
                                       codec=config.get("codec"),
                                       timeout=30.0)["g"]
        params = params - LR * (total / N_BLOCKS)
        ckpt = None
        if rank == 0:
            ckpt = tr.Checkpoint.from_dict(
                {"step": step + 1, "params": params},
                _os.path.join(config["ck_dir"], f"{pkg}_s{seq}_{step}"))
        session.report({"step": step + 1, "loss": float(_np.square(params).sum()),
                        "world": session.get_world_size()}, checkpoint=ckpt)


def _ref_params(steps):
    p = np.zeros(DIM, np.float32)
    for s in range(steps):
        total = np.zeros(DIM, np.float32)
        for i in range(N_BLOCKS):
            total = total + _block_grad(i, s)
        p = p - LR * (total / N_BLOCKS)
    return p


KILL = [{"site": "ring.send", "match": {"rank": 1}, "after": 5,
         "action": "exit", "count": 1}]


def _config(pkg, tmp_path, specs, **extra):
    return {"pkg": pkg, "steps": STEPS, "ck_dir": str(tmp_path / "ck"),
            "specs": specs, "kill_rank": 1, **extra}


def _port_fit(tmp_path, specs, runtime, **extra):
    # JaxTrainer's pack_callable drops the by-value registration on exit
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    return train.Trainer(
        _numpy_loop, train_loop_config=_config("ray_tpu_torch", tmp_path, specs,
                                               **extra),
        scaling_config=train.ScalingConfig(
            num_workers=2, backend="dcn", min_workers=1,
            placement_strategy="PACK", device="cpu"),
        run_config=train.RunConfig(name="hosted", storage_path=str(tmp_path / "p"),
                                   max_failures=1, max_inplace_resumes=4),
        datasets={"train": list(range(N_BLOCKS))}, runtime=runtime).fit()


def test_hosted_dcn_rank_death_resumes_in_place(cluster, tmp_path):
    rt = RayTrainRuntime()
    with _time_limit(240):
        r = _port_fit(tmp_path, KILL, rt)
    assert r.error is None, r.error
    assert r.resumes == {"inplace": 1, "gang": 0}
    assert [m["step"] for m in r.metrics_history] == list(range(1, STEPS + 1))
    final = r.checkpoint.to_dict()
    np.testing.assert_allclose(final["params"], _ref_params(STEPS),
                               rtol=1e-5, atol=1e-6)
    assert [a["mode"] for name, a in rt.spans if name == "train.resume"] == \
        ["inplace"]


def test_hosted_matches_jax_trainer_under_one_fault_script(cluster, tmp_path):
    """The same loop and fault script through JaxTrainer and the port's
    Trainer on the same cluster: equal histories and resume counts."""
    with _time_limit(300):
        jr, pr = _both_fits(tmp_path)
    assert jr.error is None and pr.error is None, (jr.error, pr.error)
    assert pr.resumes == jr.resumes == {"inplace": 1, "gang": 0}
    assert pr.metrics_history == jr.metrics_history


def _both_fits(tmp_path):
    jr = JaxTrainer(
        _numpy_loop, train_loop_config=_config("ray_tpu", tmp_path, KILL),
        scaling_config=JScalingConfig(num_workers=2, resources_per_worker={"CPU": 1},
                                      backend="dcn", min_workers=1,
                                      placement_strategy="PACK"),
        run_config=JRunConfig(name="jhosted", storage_path=str(tmp_path / "j"),
                              max_failures=1, max_inplace_resumes=4),
        datasets={"train": list(range(N_BLOCKS))}).fit()
    jfi.clear()
    return jr, _port_fit(tmp_path, KILL, RayTrainRuntime())


def test_hosted_dcn_passes_the_codec_to_the_ring(cluster, tmp_path):
    with _time_limit(240):
        r = _port_fit(tmp_path, None, RayTrainRuntime(), codec="bf16")
    assert r.error is None, r.error
    np.testing.assert_allclose(r.checkpoint.to_dict()["params"],
                               _ref_params(STEPS), rtol=2e-2, atol=2e-2)


def _gloo_loop(config):
    import torch as _torch
    import torch.distributed as dist

    from ray_tpu_torch.train import session

    rank = session.get_world_rank()
    t = _torch.full((4,), float(rank + 1))
    dist.all_reduce(t)
    session.report({"world": dist.get_world_size(), "rank": dist.get_rank(),
                    "sum": t.tolist(), "backend": dist.get_backend(),
                    "group": session.get_collective_group()})


def test_hosted_torch_backend_over_gloo(cluster, tmp_path):
    with _time_limit(240):
        r = train.Trainer(
            _gloo_loop, scaling_config=train.ScalingConfig(
                num_workers=2, backend="torch", placement_strategy="PACK",
                device="cpu"),
            run_config=train.RunConfig(storage_path=str(tmp_path)),
            runtime=RayTrainRuntime()).fit()
    assert r.error is None, r.error
    assert r.metrics == {"world": 2, "rank": 0, "sum": [3.0] * 4,
                         "backend": "gloo", "group": None}
