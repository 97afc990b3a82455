"""Group epochs of the port's collective (``ray_tpu_torch/collective/
collective.py``), held to the behaviours of JAX's
tests/test_collective_elastic.py.

- a frame below a group's epoch floor is dropped at ingress (JAX's
  ``_rpc_coll_msg``), one at the floor lands in the process's mailbox;
- an abort frame of an older epoch is ignored, one of the live epoch
  wakes a rank blocked in a receive with a ``CollectiveAbortError``
  naming the group, rank, epoch, op and origin (JAX's
  ``_rpc_coll_abort``);
- a reform that does not bump past the live epoch raises, as JAX's; a
  reform tears the old incarnation down (its socket closed, its floor
  raised) and the new one works;
- after a reform, a world-2 int8 ring with error feedback gives the bits
  of a fresh group and of JAX's ring (JAX's
  ``test_reform_drops_ef_residuals_numerics``);
- a join is abortable: ``abort_all_local`` ends a join in progress, and
  ``abort_join`` ends one in progress or before it starts, with
  ``CollectiveAbortError``, not the join's timeout.

Sockets here are of one rank a group (the registry is by name); groups
of processes are in tests/test_torch_train_procs.py.
"""

import contextlib
import os
import signal
import tempfile
import threading
import time

import numpy as np
import pytest

from ray_tpu.collective import ring as jring
from ray_tpu_torch.collective import collective as col
from ray_tpu_torch.collective import ring

from test_torch_collective_ring import jax_world, port_world


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


@pytest.fixture
def sock_dir():
    with tempfile.TemporaryDirectory(prefix="rtt_epochs_") as d:
        yield d


def _addr(root, tag):
    return col.socket_addresses(root, tag, 1)


def test_stale_epoch_frames_rejected_at_ingress():
    with _time_limit(30):
        name = "stale-frames-unit"
        col._min_epochs[name] = 3
        try:
            assert col._ingress(name, 2, (1, 0, "t"), b"old") is False
            assert (name, 2, 1, 0, "t") not in col._mailbox().msgs
            assert col._ingress(name, 3, (1, 0, "t"), b"new") is True
            assert col._mailbox().msgs.pop((name, 3, 1, 0, "t")) == b"new"
        finally:
            col._min_epochs.pop(name, None)


def test_stale_abort_frame_ignored_and_live_one_wakes_a_receive(sock_dir):
    with _time_limit(30):
        name = "abort-unit"
        fabric = col.SocketFabric(name, 0, _addr(sock_dir, "a"), b"k" * 16,
                                  epoch=7)
        g = col.Group(name, 2, 0, fabric, epoch=7)
        try:
            fabric._deliver(("abort", 6, {"reason": "old", "origin": 1}))
            assert fabric.abort_record(0) is None
            got = []

            def waiter():
                t0 = time.monotonic()
                try:
                    g._recv_obj(1, 1, "t", timeout=30.0, op="unit-op")
                except col.CollectiveAbortError as e:
                    got.append((e, time.monotonic() - t0))

            th = threading.Thread(target=waiter, daemon=True)
            th.start()
            time.sleep(0.3)
            fabric._deliver(("abort", 7, {"reason": "unit kill", "origin": 1}))
            th.join(5)
            assert not th.is_alive(), "the receive never woke on the abort"
            e, dt = got[0]
            assert dt < 3.0  # woken by the abort, not the 30 s timeout
            assert (e.group, e.rank, e.epoch, e.origin_rank, e.op) == \
                (name, 0, 7, 1, "unit-op")
            assert "unit kill" in str(e)
            with pytest.raises(col.CollectiveAbortError):  # sticky
                g._poll_abort(op="next-op")
        finally:
            fabric.close()


def test_reform_must_bump_and_replaces_the_incarnation(sock_dir):
    with _time_limit(60):
        name = "reform-unit"
        key = os.urandom(16)
        first = _addr(sock_dir, "e1")
        try:
            g = col.init_collective_group(1, 0, group_name=name,
                                          addresses=first, authkey=key,
                                          epoch=1)
            assert (col.get_rank(name), col.get_collective_group_size(name),
                    col.collective_epoch(name)) == (0, 1, 1)
            assert os.path.exists(first[0])
            for stale in (1, 0):
                with pytest.raises(ValueError, match="does not bump"):
                    col.reform_group(1, 0, name, addresses=_addr(sock_dir, "x"),
                                     authkey=key, epoch=stale)
            assert col.get_group(name) is g  # the live one is untouched
            second = _addr(sock_dir, "e2")
            g2 = col.reform_group(1, 0, name, addresses=second, authkey=key,
                                  epoch=2)
            assert g2.epoch == 2 and col.get_group(name) is g2
            assert not os.path.exists(first[0])  # the old socket closed
            assert col._min_epochs[name] == 2
            assert col._ingress(name, 1, (1, 0, "t"), b"straggler") is False
            x = np.arange(5, dtype=np.float32)
            assert np.array_equal(col.allreduce(g2, x), x)
            assert col.reform_group(1, 0, name, addresses=_addr(sock_dir, "e3"),
                                    authkey=key).epoch == 3  # None bumps one
            assert col.join_count(name) == 3
        finally:
            col.destroy_collective_group(name)
        assert col.get_rank(name) == -1 and col.collective_epoch(name) == 0
        assert col._min_epochs.pop(name) == 4
        col._inc_counts.pop(name, None)
        with pytest.raises(ValueError, match="must be given"):
            col.reform_group(1, 0, name, addresses=_addr(sock_dir, "e5"),
                             authkey=key)


def test_reform_drops_ef_residuals_numerics():
    """A reform destroys the old incarnation, which drops its residuals:
    the world-2 int8 ring afterwards equals a fresh group's, and JAX's
    ring on the same payloads, bit for bit."""
    with _time_limit(60):
        data = {r: np.random.default_rng(50 + r).standard_normal(512)
                .astype(np.float32) for r in range(3)}

        def int8_round(g, r):
            return ring.ring_allreduce(g, data[r], codec="int8", ef_tag="w",
                                       timeout=30)

        fabric = col.LocalFabric(3)
        groups = [col.Group("ef-reform", 3, r, fabric) for r in range(3)]
        outs = [None] * 3
        threads = [threading.Thread(target=lambda r=r: outs.__setitem__(
            r, int8_round(groups[r], r))) for r in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert any(k[0] == "ef-reform" for k in ring._ef_store)
        col.destroy_collective_group("ef-reform")
        assert not any(k[0] == "ef-reform" for k in ring._ef_store)
        col._min_epochs.pop("ef-reform", None)
        reformed = port_world(2, int8_round, name="ef-reform")
        fresh = port_world(2, int8_round, name="ef-fresh")
        want = jax_world(2, lambda g, r: jring.ring_allreduce(
            g, data[r], codec="int8", ef_tag="w", timeout=30), name="ef-jax")
        for a, b, c in zip(reformed, fresh, want):
            assert a.tobytes() == b.tobytes() == np.asarray(c).tobytes()


def test_abort_all_local_ends_a_join_in_progress(sock_dir):
    """Rank 0 of a world-2 group waits for a rank 1 that never comes; the
    abort ends its join with CollectiveAbortError at once."""
    with _time_limit(60):
        name = "join-abort-unit"
        errs = []

        def join():
            try:
                col.init_collective_group(
                    2, 0, group_name=name,
                    addresses=col.socket_addresses(sock_dir, "j", 2),
                    authkey=b"k" * 16, epoch=1, timeout=60)
            except col.CollectiveAbortError as e:
                errs.append((e, time.monotonic()))

        th = threading.Thread(target=join, daemon=True)
        th.start()
        deadline = time.monotonic() + 10
        while name not in col._joins and time.monotonic() < deadline:
            time.sleep(0.01)
        assert name in col._joins
        t0 = time.monotonic()
        assert col.abort_all_local("driver: quiesce") == 1
        th.join(10)
        assert not th.is_alive()
        e, t1 = errs[0]
        assert t1 - t0 < 2.0
        assert (e.group, e.rank, e.epoch, e.op) == (name, 0, 1, "join")
        assert name not in col._groups and name not in col._joins
        col._min_epochs.pop(name, None)


@pytest.mark.parametrize("when", ["before", "during"])
def test_abort_join_ends_the_named_join(sock_dir, when):
    with _time_limit(60):
        name = f"join-named-{when}"
        addresses = col.socket_addresses(sock_dir, when, 2)
        if when == "before":
            col.abort_join(name, 4, "rank 1 died")
        errs = []

        def join():
            try:
                col.init_collective_group(2, 0, group_name=name,
                                          addresses=addresses,
                                          authkey=b"k" * 16, epoch=4,
                                          timeout=60)
            except col.CollectiveAbortError as e:
                errs.append(e)

        th = threading.Thread(target=join, daemon=True)
        t0 = time.monotonic()
        th.start()
        if when == "during":
            while name not in col._joins and time.monotonic() < t0 + 10:
                time.sleep(0.01)
            col.abort_join(name, 3, "another epoch")  # not this join's
            time.sleep(0.2)
            assert th.is_alive()
            col.abort_join(name, 4, "rank 1 died")
        th.join(10)
        assert not th.is_alive() and time.monotonic() - t0 < 5
        assert errs[0].op == "join" and errs[0].epoch == 4
        assert "rank 1 died" in str(errs[0])
        col._join_aborts.pop((name, 3), None)
        assert not os.path.exists(addresses[0])  # its listener closed
