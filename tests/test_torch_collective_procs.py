"""The process runtime's collective (``ProcessRuntime.collective``) on
the CPU: members in processes of their own, linked to each other over
``AF_UNIX`` sockets, not through the parent process.

Held here: a 3-member ring over processes gives each member the bits the
threaded ring (``LocalFabric``, itself held to JAX's ring in
tests/test_torch_collective_ring.py) gives the same rank, with the same
``OpStats``; ``LearnerGroup(num_learners=2)`` over processes ends with
the in-process group's weights, bit for bit, on both members; a member
SIGKILLed in the middle of a collective, or after it joined and before
its first, makes the others raise ``CollectiveAbortError`` (naming the
group and their rank) within 10 s;
``shutdown()`` leaves no socket file and no process. Every get carries a
timeout, and every test a time limit.
"""

import contextlib
import os
import signal
import stat
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.collective import ring
from ray_tpu_torch.rl import learner_group
from ray_tpu_torch.serve.process_runtime import ProcessRuntime
from ray_tpu_torch.utils.trees import tree_leaves

from process_members import RingMember

GET_S = 60


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
def rt():
    runtime = ProcessRuntime()
    yield runtime
    runtime.shutdown()


def _vectors(world: int, n: int = 1001) -> list:
    rng = np.random.default_rng(19)
    return [(rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n))
            .astype(np.float32) for _ in range(world)]


def _ring_group(rt, world: int, name: str):
    """``world`` ring members and their sockets' addresses."""
    members = [rt.spawn(RingMember, {}, name=f"{name}{r}") for r in range(world)]
    fns = rt.collective(members, name)
    pids = rt.get([rt.call(m, "join", f) for m, f in zip(members, fns)],
                  timeout=GET_S)
    assert pids == [m.pid for m in members]
    return members, fns[0].spec[3]


def _threaded_ring(vectors: list) -> list:
    world = len(vectors)
    fabric = col.LocalFabric(world)
    groups = [col.Group("threads", world, r, fabric) for r in range(world)]
    out = [None] * world

    def go(r):
        v = ring.ring_allreduce(groups[r], vectors[r], op="sum")
        out[r] = (v, ring.last_op_stats("threads", r))

    threads = [threading.Thread(target=go, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    ring.purge_group("threads")
    return out


def test_three_member_ring_equals_the_threaded_ring(rt):
    with _time_limit(120):
        members, _ = _ring_group(rt, 3, "ring")
        vectors = _vectors(3)
        try:
            for _ in range(2):  # the links are made once, then reused
                got = rt.get([rt.call(m, "reduce", v)
                              for m, v in zip(members, vectors)], timeout=GET_S)
                stats = rt.get([rt.call(m, "stats") for m in members],
                               timeout=GET_S)
                want = _threaded_ring(vectors)
                for r in range(3):
                    assert got[r].dtype == np.float32
                    assert got[r].tobytes() == want[r][0].tobytes()
                    st = want[r][1]
                    assert stats[r] == {
                        "tensor_bytes": st.tensor_bytes,
                        "bytes_sent": st.bytes_sent,
                        "bytes_recv": st.bytes_recv, "chunks": st.chunks}
                # 2·(N−1)/N of the vector's bytes a rank, give or take a
                # ragged segment
                assert sum(s["bytes_sent"] for s in stats) == \
                    2 * 2 * vectors[0].nbytes
        finally:
            for m in members:
                rt.kill(m)


def _ppo_batch(n: int = 64) -> dict:
    rng = np.random.RandomState(1400)
    return {"obs": rng.randn(n, 4).astype(np.float32),
            "actions": rng.randint(0, 2, n).astype(np.int32),
            "logp": (-np.abs(rng.randn(n))).astype(np.float32),
            "advantages": rng.randn(n).astype(np.float32),
            "returns": rng.randn(n).astype(np.float32)}


def _weights_of(group) -> list:
    rt = group.runtime
    return rt.get([rt.call(m, "get_weights") for m in group.learners],
                  timeout=GET_S)


def test_learner_group_over_processes_equals_in_process(rt):
    with _time_limit(180):
        batch = _ppo_batch()
        local = learner_group.LearnerGroup(4, 2, num_learners=2, device="cpu")
        try:
            local.update(dict(batch), minibatches=1, epochs=3)
            want = _weights_of(local)
        finally:
            local.shutdown()
        procs = learner_group.LearnerGroup(4, 2, num_learners=2, runtime=rt,
                                           device="cpu")
        try:
            procs.update(dict(batch), minibatches=1, epochs=3)
            got = _weights_of(procs)
            stats = rt.get([rt.call(m, "collective_stats")
                            for m in procs.learners], timeout=GET_S)
        finally:
            procs.shutdown()
        for member in got + want[1:]:
            for a, b in zip(tree_leaves(member), tree_leaves(want[0])):
                assert torch.equal(a, b)
        # N = 2: each rank sends the whole vector once (2·(N−1)/N)
        for st in stats:
            assert st.op == "allreduce" and st.transport == "ring"
            assert st.bytes_sent == st.tensor_bytes > 0


def test_a_sigkilled_member_aborts_the_others_within_10s(rt):
    with _time_limit(120):
        members, _ = _ring_group(rt, 3, "doomed")
        vectors = _vectors(3)
        rt.get([rt.call(m, "reduce", v) for m, v in zip(members, vectors)],
               timeout=GET_S)  # the links are up
        refs = [rt.call(members[r], "reduce", vectors[r]) for r in (0, 2)]
        time.sleep(0.5)  # ranks 0 and 2 are waiting inside the ring
        t0 = time.monotonic()
        rt.kill(members[1])
        for r, ref in zip((0, 2), refs):
            with pytest.raises(col.CollectiveAbortError) as err:
                rt.get(ref, timeout=GET_S)
            assert (err.value.group, err.value.rank) == ("doomed", r)
            assert err.value.op.startswith("ar:")
        assert time.monotonic() - t0 < 10
        for r in (0, 2):
            rt.kill(members[r])


@pytest.mark.parametrize("others_wait", [False, True],
                         ids=["before-they-call", "while-they-wait"])
def test_a_member_killed_before_its_first_collective_aborts_the_others(
        rt, others_wait):
    """Joining links a member to its peers, so a member that dies before
    any collective has run (killed, or lost in its first update's
    forward pass) is EOF all the same: the others' first collective
    raises ``CollectiveAbortError`` within 10 s, whether they enter it
    after the death or are already waiting in it."""
    with _time_limit(120):
        name = f"early-{others_wait}"
        members, _ = _ring_group(rt, 3, name)
        vectors = _vectors(3)
        refs = []
        if others_wait:
            refs = [rt.call(members[r], "reduce", vectors[r]) for r in (0, 2)]
            time.sleep(0.5)  # ranks 0 and 2 are waiting inside the ring
        t0 = time.monotonic()
        rt.kill(members[1])
        if not others_wait:
            refs = [rt.call(members[r], "reduce", vectors[r]) for r in (0, 2)]
        for r, ref in zip((0, 2), refs):
            with pytest.raises(col.CollectiveAbortError) as err:
                rt.get(ref, timeout=GET_S)
            assert (err.value.group, err.value.rank) == (name, r)
            assert err.value.op.startswith("ar:")
        assert time.monotonic() - t0 < 10
        for r in (0, 2):
            rt.kill(members[r])


def test_shutdown_leaves_no_socket_file_and_no_process():
    with _time_limit(120):
        own = ProcessRuntime()
        members, addresses = _ring_group(own, 2, "g")
        own.get([own.call(m, "reduce", v)
                 for m, v in zip(members, _vectors(2))], timeout=GET_S)
        # files in the store's directory (unless its path is too long for
        # a socket: then names in the abstract namespace, with no file)
        socks = [a for a in addresses if not a.startswith("\0")]
        assert all(os.path.dirname(a) == own._root for a in socks)
        assert all(stat.S_ISSOCK(os.stat(a).st_mode) for a in socks)
        own.shutdown()
        assert not os.path.exists(own._root)
        assert not any(os.path.exists(a) for a in socks)
        for m in members:
            assert m.process.exitcode is not None
            with pytest.raises(ProcessLookupError):
                os.kill(m.pid, 0)
