"""Small members for tests/test_torch_process_runtime.py and
tests/test_torch_collective_procs.py, and the worker functions of
tests/test_torch_train_procs.py.

The process runtime's members import their class by its module path,
and a train worker process its functions, so these live in a module of
their own that imports neither JAX nor torch at import: a member process
built from one starts in well under a second. The train workers' loops
import the port's train package when they run.
"""

import os
import sys
import threading
import time

import numpy as np


def mapped_file(address: int):
    """The base name of the file mapped at ``address`` in this process,
    by /proc/self/maps; None for memory no file backs."""
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split()
            lo, hi = (int(x, 16) for x in parts[0].split("-"))
            if lo <= address < hi:
                return os.path.basename(parts[5]) if len(parts) > 5 else None
    return None


class Recorder:
    """Logs each call's start and end; holds the constructor's ``blob``."""

    def __init__(self, tag: str = "", blob=None):
        self.tag, self.blob = tag, blob
        self.log: list = []
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(2, timeout=20)

    def pid(self) -> int:
        return os.getpid()

    def modules(self) -> list:
        """Which of jax, ray_tpu and torch this process has imported."""
        return sorted(m for m in ("jax", "ray_tpu", "torch")
                      if m in sys.modules)

    def step(self, x, delay: float = 0.0):
        with self._lock:
            self.log.append(("start", x))
        time.sleep(delay)
        with self._lock:
            self.log.append(("end", x))
        return x

    def record(self) -> list:
        with self._lock:
            return list(self.log)

    def meet(self) -> bool:
        """Returns once a second call is in ``meet`` at the same time."""
        self._barrier.wait()
        return True

    def describe(self, tree) -> dict:
        """How a tree arrived here: each array leaf's sum and the name of
        the file its bytes are mapped from (None: not a file's)."""
        if isinstance(tree, dict):
            return {k: self.describe(v) for k, v in tree.items()}
        if isinstance(tree, np.ndarray):
            return {"file": mapped_file(tree.ctypes.data),
                    "sum": float(tree.sum())}
        if type(tree).__name__ == "Tensor":
            return {"file": mapped_file(tree.data_ptr()),
                    "sum": float(tree.float().sum())}
        return {"type": type(tree).__name__}

    def blob_described(self) -> dict:
        return self.describe(self.blob)

    def echo(self, *args, **kwargs):
        return args, kwargs

    def keep(self, x) -> None:
        self.kept = x

    def kept_value(self):
        return self.kept

    def drop(self) -> None:
        self.kept = None

    def off_host_tensor(self):
        import torch

        return torch.empty(2, device="meta")  # a tensor that is not on the CPU

    def sleep(self, seconds: float) -> float:
        time.sleep(seconds)
        return seconds

    def die(self, code: int = 3):
        os._exit(code)


class RefusingInit:
    def __init__(self, why: str):
        raise ValueError(f"refused: {why}")


class DyingInit:
    def __init__(self):
        os._exit(7)


class RingMember:
    """Holds its callable of ``ProcessRuntime.collective`` and calls it
    (the callable imports the port's collective package, and torch with
    it, when it arrives)."""

    def join(self, allreduce) -> int:
        self.allreduce = allreduce
        return os.getpid()

    def reduce(self, vector, timeout: float = 60.0):
        return self.allreduce(vector, timeout=timeout)

    def stats(self):
        st = self.allreduce.stats()
        return None if st is None else {
            "tensor_bytes": st.tensor_bytes, "bytes_sent": st.bytes_sent,
            "bytes_recv": st.bytes_recv, "chunks": st.chunks}


# ---------------------------------------------------------------------------
# the train workers' functions (tests/test_torch_train_procs.py)
# ---------------------------------------------------------------------------

N_BLOCKS, DIM, LR = 8, 16, 0.1


def block_grad(i, step):
    """tests/test_torch_train_hosted.py's _block_grad."""
    rng = np.random.default_rng(7919 * (i + 1) + step)
    return rng.standard_normal(DIM).astype(np.float32)


def numpy_loop(config):
    """tests/test_torch_train_hosted.py's _numpy_loop over the port's train
    modules, which arms the port's own fault_injection (on the first
    incarnation of its rank only): each step sums its shard's block
    gradients, syncs the total with dcn_allreduce_grads, and rank 0
    checkpoints a dict. With config["stubborn"], rank 0 of the first
    incarnation makes one more collective after step 2's report and,
    when it is aborted, swallows the abort and sleeps: a survivor that
    will not quiesce."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.train import fault_injection, session

    rank, seq = session.get_world_rank(), session.get_resume_seq()
    if seq == 0 and config.get("specs") and rank == config.get("kill_rank"):
        fault_injection.configure(config["specs"])
    shard = session.get_dataset_shard("train")
    group = session.get_collective_group()
    params = np.zeros(DIM, np.float32)
    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        d = ck.to_dict()
        params = np.asarray(d["params"], np.float32)
        start = int(d["step"])
    for step in range(start, config["steps"]):
        for _block in shard:
            pass
        contrib = np.zeros(DIM, np.float32)
        for i in shard.assigned_indices():
            contrib = contrib + block_grad(i, step)
        total = tr.dcn_allreduce_grads({"g": contrib}, group, op="sum",
                                       codec=config.get("codec"),
                                       timeout=30.0)["g"]
        params = params - LR * (total / N_BLOCKS)
        ckpt = None
        if rank == 0:
            ckpt = tr.Checkpoint.from_dict(
                {"step": step + 1, "params": params},
                os.path.join(config["ck_dir"],
                             f"ray_tpu_torch_s{seq}_{step}"))
        session.report({"step": step + 1,
                        "loss": float(np.square(params).sum()),
                        "world": session.get_world_size()}, checkpoint=ckpt)
        if config.get("stubborn") and seq == 0 and rank == 0 and step == 1:
            try:
                tr.dcn_allreduce_grads({"g": np.ones(2, np.float32)}, group,
                                       timeout=30.0)
            except Exception:  # noqa: BLE001 — wedged: swallows the abort
                time.sleep(120.0)  # the gang restart kills this process
                raise


def gloo_loop(config):
    """tests/test_torch_train_hosted.py's _gloo_loop: one all_reduce over
    the torch backend's process group."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import session

    rank = session.get_world_rank()
    t = torch.full((4,), float(rank + 1))
    dist.all_reduce(t)
    session.report({"world": dist.get_world_size(), "rank": dist.get_rank(),
                    "sum": t.tolist(), "backend": dist.get_backend(),
                    "group": session.get_collective_group()})


def worker_allreduce(worker, group_name, value, timeout=30.0):
    """A sum over the gang's group of a vector of ``value``, with this
    worker's identity and pid."""
    out = worker.allreduce(np.full(4, float(value), np.float32), group_name,
                           timeout=timeout)
    return {"out": np.asarray(out).tolist(), "idx": worker.worker_idx,
            "pid": os.getpid()}


def worker_state(worker, key=None, value=None):
    """Sets ``state[key]`` when ``value`` is given; returns the state's keys."""
    if value is not None:
        worker.state[key] = value
    return sorted(worker.state)


def worker_epoch(worker, group_name):
    """This worker process's live epoch of the group (0: none)."""
    from ray_tpu_torch.collective import collective

    return collective.collective_epoch(group_name)
