"""The port's process runtime (``serve.process_runtime.ProcessRuntime``)
held to ``serve/runtime.py``'s contract, on the CPU.

The members are the small classes of ``tests/process_members.py``, each
in a process of its own, all through one runtime for the module. Held
here: calls start in the order they were sent (and so run in it at
``max_concurrency`` 1), two run at once at 2; ``wait`` hands back the
ref objects it was given; a put's ref in the constructor's kwargs and in
a call's arguments arrives in the member mapped from the store's files,
and one deeper in an argument arrives as a ref; ``put(owned=True)``
outlives its source buffer; a put's files are removed once no ref to
it is left, in this process or in a member; a constructor's exception is raised with its
text and the member's traceback; a tensor off the CPU is refused with a
``TypeError`` naming the method, both ways (a ``meta`` tensor stands for a
CUDA one); ``kill`` fails the calls in flight and every later one with
``actor_error``, and a member that exits on its own is found the same
way; ``collective`` and ``deploy`` raise; no member outlives
``shutdown()``; and no member imports JAX or ray_tpu. Every ``get``
carries a timeout.
"""

import os
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.serve.process_runtime import ProcessRuntime, StoreRef
from ray_tpu_torch.serve.runtime import ActorError

from process_members import DyingInit, Recorder, RefusingInit

GET_S = 60  # every get's timeout


@pytest.fixture(scope="module")
def rt():
    runtime = ProcessRuntime()
    yield runtime
    runtime.shutdown()


@pytest.fixture(scope="module")
def member(rt):
    return rt.spawn(Recorder, {"tag": "m"}, name="recorder",
                    max_concurrency=1)


def test_member_is_a_process_of_its_own_without_jax(rt, member):
    pid = rt.get(rt.call(member, "pid"), timeout=GET_S)
    assert pid == member.pid != os.getpid()
    assert member.process.is_alive()
    assert member.boot_s > 0 and member.build_s >= 0
    assert rt.get(rt.call(member, "modules"), timeout=GET_S) == []


def test_calls_start_and_run_in_the_order_sent(rt):
    m = rt.spawn(Recorder, {}, name="ordered", max_concurrency=1)
    refs = [rt.call(m, "step", i, delay=0.02 * (i % 3 == 0))
            for i in range(12)]
    assert rt.get(refs, timeout=GET_S) == list(range(12))
    log = rt.get(rt.call(m, "record"), timeout=GET_S)
    assert log == [(ev, i) for i in range(12) for ev in ("start", "end")]
    rt.kill(m)


def test_two_calls_run_at_once_at_concurrency_two(rt):
    m = rt.spawn(Recorder, {}, name="pair", max_concurrency=2)
    assert rt.get([rt.call(m, "meet"), rt.call(m, "meet")],
                  timeout=GET_S) == [True, True]
    rt.kill(m)


def test_wait_returns_the_same_ref_objects(rt, member):
    slow = rt.call(member, "sleep", 0.3)
    fast = rt.call(member, "echo", 1)
    put = rt.put({"x": 1})
    refs = [slow, fast, put]
    ready, pending = rt.wait(refs, num_returns=1, timeout=GET_S)
    assert ready == [put] and ready[0] is put
    assert all(a is b for a, b in zip(pending, [slow, fast]))
    ready, pending = rt.wait(refs, num_returns=3, timeout=GET_S)
    assert pending == [] and all(a is b for a, b in zip(ready, refs))
    keyed = {r: i for i, r in enumerate(refs)}  # the RL layer keys them
    assert [keyed[r] for r in ready] == [0, 1, 2]


def _blob():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((128, 256)).astype(np.float32),
            "small": np.arange(5, dtype=np.int32),
            "t": torch.arange(4096, dtype=torch.bfloat16),
            "meta": {"n": 3, "name": "x"}}


def test_put_refs_resolve_in_the_member_mapped_from_the_store(rt):
    blob = _blob()
    ref = rt.put(blob)
    assert rt.is_ref(ref) and isinstance(ref, StoreRef)
    m = rt.spawn(Recorder, {"blob": ref}, name="mapped")
    want = {"w": float(blob["w"].sum()), "small": 10.0,
            "t": float(blob["t"].float().sum())}
    for got in (rt.get(rt.call(m, "blob_described"), timeout=GET_S),
                rt.get(rt.call(m, "describe", ref), timeout=GET_S)):
        assert got["w"] == {"file": "0.npy", "sum": want["w"]}
        assert got["t"] == {"file": "tensors.pt", "sum": want["t"]}
        # a small array is pickled with the tree: no file of its own
        assert got["small"] == {"file": None, "sum": want["small"]}
        assert got["meta"] == {"n": {"type": "int"},
                               "name": {"type": "str"}}
    # a ref deeper in an argument arrives as a ref, and get maps it
    (args, kwargs) = rt.get(rt.call(m, "echo", [ref], k={"r": ref}),
                            timeout=GET_S)
    assert isinstance(args[0][0], StoreRef) and args[0][0].path == ref.path
    back = rt.get(kwargs["k"]["r"], timeout=GET_S)
    np.testing.assert_array_equal(back["w"], blob["w"])
    assert torch.equal(back["t"], blob["t"]) and back["meta"] == blob["meta"]
    rt.kill(m)


def test_a_calls_ref_is_sent_as_its_value_after_earlier_calls(rt, member):
    slow = rt.call(member, "sleep", 0.2)
    value = rt.call(member, "echo", 7)
    (args, _) = rt.get(rt.call(member, "echo", value), timeout=GET_S)
    assert args == (((7,), {}),)
    assert rt.get(slow, timeout=GET_S) == 0.2


def test_owned_put_outlives_its_source_buffer(rt, tmp_path):
    path = tmp_path / "src.npy"
    np.save(path, np.arange(65536, dtype=np.float32))
    src = np.load(path, mmap_mode="r+")
    ref = rt.put({"a": src[1:]}, owned=True)
    want = np.arange(1, 65536, dtype=np.float32)
    src[:] = -1
    src.flush()
    del src
    os.remove(path)
    np.testing.assert_array_equal(rt.get(ref, timeout=GET_S)["a"], want)


def _gone(path: str) -> bool:
    """Whether ``path`` is removed within a few seconds (a member hands
    its borrows back on a thread of its own)."""
    deadline = time.monotonic() + 10
    while os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.02)
    return not os.path.exists(path)


def test_a_put_is_freed_once_no_ref_to_it_is_left(rt, member):
    tree = {"w": np.zeros(65536, np.float32)}
    # a top-level ref: mapped by the member, then handed back
    ref = rt.put(tree)
    path = ref.path
    assert rt.get(rt.call(member, "describe", ref), timeout=GET_S)["w"] == {
        "file": "0.npy", "sum": 0.0}
    assert os.path.isdir(path)
    del ref
    assert _gone(path)
    # a ref a member keeps keeps the put, and comes back as the same object
    keeper = rt.spawn(Recorder, {}, name="keeper")
    ref = rt.put(tree)
    path = ref.path
    rt.get(rt.call(keeper, "keep", [ref]), timeout=GET_S)
    (back,) = rt.get(rt.call(keeper, "kept_value"), timeout=GET_S)
    assert back is ref
    del ref, back
    time.sleep(0.2)
    assert os.path.isdir(path)
    rt.get(rt.call(keeper, "drop"), timeout=GET_S)
    assert _gone(path)
    # a member's borrows end with it
    ref = rt.put(tree)
    path = ref.path
    rt.get(rt.call(keeper, "keep", {"r": ref}), timeout=GET_S)
    del ref
    time.sleep(0.2)
    assert os.path.isdir(path)
    rt.kill(keeper)
    assert not os.path.exists(path)


def test_constructor_exception_is_raised_with_its_text(rt):
    with pytest.raises(ValueError, match="refused: no") as info:
        rt.spawn(RefusingInit, {"why": "no"}, name="refuser")
    tb = str(info.value.__cause__)
    assert "Traceback" in tb and "process_members.py" in tb and "refused" in tb
    with pytest.raises(ActorError, match="died before its constructor"):
        rt.spawn(DyingInit, {}, name="dies")


def test_a_tensor_off_the_cpu_is_refused_naming_the_method(rt, member):
    meta = torch.empty(3, device="meta")
    with pytest.raises(TypeError, match="echo: a tensor on meta"):
        rt.call(member, "echo", {"x": [meta]})
    with pytest.raises(TypeError, match="put: a tensor on meta"):
        rt.put({"x": meta})
    with pytest.raises(TypeError, match="recorder.__init__: a tensor on meta"):
        rt.spawn(Recorder, {"blob": meta}, name="recorder")
    with pytest.raises(TypeError, match="off_host_tensor: a tensor on meta"):
        rt.get(rt.call(member, "off_host_tensor"), timeout=GET_S)
    # the member still serves
    assert rt.get(rt.call(member, "echo", 1), timeout=GET_S) == ((1,), {})


def test_kill_fails_calls_in_flight_and_later(rt):
    m = rt.spawn(Recorder, {}, name="victim", max_concurrency=2)
    inflight = [rt.call(m, "sleep", 30), rt.call(m, "sleep", 30)]
    time.sleep(0.2)
    t0 = time.monotonic()
    rt.kill(m)
    for ref in inflight:
        with pytest.raises(rt.actor_error):
            rt.get(ref, timeout=GET_S)
    with pytest.raises(rt.actor_error):
        rt.get(rt.call(m, "echo", 1), timeout=GET_S)
    assert time.monotonic() - t0 < 10
    assert m.process.exitcode is not None


def test_a_member_that_exits_on_its_own_is_found(rt):
    m = rt.spawn(Recorder, {}, name="leaver", max_concurrency=2)
    pending = rt.call(m, "sleep", 30)
    with pytest.raises(rt.actor_error, match="exit code 3"):
        rt.get(rt.call(m, "die", 3), timeout=GET_S)
    with pytest.raises(rt.actor_error):
        rt.get(pending, timeout=GET_S)
    ready, _ = rt.wait([pending], timeout=GET_S)
    assert ready == [pending]
    with pytest.raises(rt.actor_error):
        rt.get(rt.call(m, "echo", 1), timeout=GET_S)


def test_collective_and_deploy_raise(rt, member):
    with pytest.raises(NotImplementedError, match="InProcessRuntime"):
        rt.collective([member], "g")
    with pytest.raises(NotImplementedError, match="InProcessRuntime"):
        rt.deploy(Recorder, name="r", route_prefix="/r",
                  max_concurrent_queries=1)
    with pytest.raises(NotImplementedError, match="InProcessRuntime"):
        rt.http_address()
    with pytest.raises(ValueError, match="__main__"):
        rt.spawn(type("Local", (), {"__module__": "__main__"}), {})


def test_no_member_outlives_shutdown():
    own = ProcessRuntime()
    members = [own.spawn(Recorder, {}, name=f"r{i}") for i in range(2)]
    ref = own.put({"w": np.zeros(65536, np.float32)})
    store = os.path.dirname(ref.path)
    busy = own.call(members[0], "sleep", 30)
    assert os.path.isdir(store) and own.is_initialized()
    own.shutdown()
    assert not own.is_initialized() and not os.path.exists(store)
    for m in members:
        assert m.process.exitcode is not None
        with pytest.raises(ProcessLookupError):
            os.kill(m.pid, 0)
    with pytest.raises(ActorError):
        own.get(busy, timeout=GET_S)
    with pytest.raises(RuntimeError, match="shut down"):
        own.spawn(Recorder, {})
