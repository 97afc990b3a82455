"""The serving pool's copied pure-Python logic against ray_tpu's own.

The port keeps its own copies of ``serve_replica_demand``,
``multiplexed`` and the admission logic of ``LLMPool``; each is called
here beside the ray_tpu function on the same inputs. The pool methods run
unbound on one stub pool per package (as tests/test_overload.py runs
ray_tpu's), on a frozen clock where they read one.
"""

import collections
import itertools
import threading
import time

import pytest

from ray_tpu.autoscaler import demand_scheduler as jdemand
from ray_tpu.serve import llm_pool as jpool
from ray_tpu.serve import multiplex as jmultiplex
from ray_tpu.serve import overload as joverload
from ray_tpu_torch.autoscaler import demand_scheduler as tdemand
from ray_tpu_torch.serve import hooks
from ray_tpu_torch.serve import llm_pool as tpool
from ray_tpu_torch.serve import multiplex as tmultiplex
from ray_tpu_torch.serve import overload as toverload

JOIN_S = 30
# the port's pool raises the runtime's classes through its hooks, so both
# stubs return the same ones
JAX_ERRORS = hooks.Hooks(overloaded_error=joverload.PoolOverloadedError,
                         deadline_error=joverload.DeadlineExceededError)


@pytest.mark.parametrize("target_ttft_s", [None, 0.5])
def test_serve_replica_demand_equals_ray_tpus(target_ttft_s):
    grid = itertools.product((0, 1, 3, 10, 100), (0, 2, 6), (1, 2, 3, 5),
                             ((1, 1), (1, 4), (2, 8)), (1.0, 2.5, 4.0),
                             (None, 0.05, 0.3, 0.5, 2.0))
    seen = set()
    for queue, inflight, n_rep, (lo, hi), per_rep, ttft in grid:
        kw = dict(queue_depth=queue, inflight=inflight, n_replicas=n_rep,
                  min_replicas=lo, max_replicas=hi,
                  target_queue_per_replica=per_rep, ttft_p99_s=ttft,
                  target_ttft_s=target_ttft_s)
        got = tdemand.serve_replica_demand(**kw)
        assert got == jdemand.serve_replica_demand(**kw), kw
        seen.add(got)
    assert seen == set(range(1, 9))  # every count the clamps allow


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_multiplexed_evicts_as_ray_tpus(capacity):
    seq = ["a", "b", "a", "c", "d", "b", "a", "e", "c", "c", "b", "f", "a"]
    loads = {"port": [], "jax": []}
    port = tmultiplex.multiplexed(capacity)(
        lambda mid: loads["port"].append(mid) or f"model:{mid}")
    ref = jmultiplex.multiplexed(capacity)(
        lambda mid: loads["jax"].append(mid) or f"model:{mid}")
    for mid in seq:
        assert port(mid) == ref(mid) == f"model:{mid}"
        assert list(port._cache) == list(ref._cache)
    assert loads["port"] == loads["jax"]
    assert len(loads["port"]) > len(set(seq)) or capacity >= len(set(seq))


METHODS = ("_tenant_state", "_tenant_turn", "_admit_rate_locked",
           "_admission_shed", "_shed", "_acquire", "_release", "_assign_seed")


def stub_pool(cls, *, waiting=0, weights=None, level=None, admits=()):
    """An object holding `cls`'s admission methods and the state they
    read, nothing else of a pool."""
    stub_cls = type("StubPool", (), {
        **{m: getattr(cls, m) for m in METHODS},
        "ACQUIRE_TIMEOUT_S": JOIN_S, "TTFT_WINDOW_S": 30.0})
    s = stub_cls()
    s._lock = threading.Lock()
    s._cond = threading.Condition(s._lock)
    s._waiting = waiting
    s._admits = collections.deque(admits, maxlen=256)
    s._tenant_weights = dict(weights or {})
    s._tenants = {}
    s._vclock = 0.0
    s._next_seed = 0
    s._replicas = []
    s._max_inflight = 1
    s._guardian = None
    if level is not None:
        s._guardian = type("Guardian", (), {"level": level})()
    s.hooks = JAX_ERRORS
    return s


def both(**kw):
    return stub_pool(tpool.LLMPool, **kw), stub_pool(jpool.LLMPool, **kw)


def test_assign_seed_equals_ray_tpus():
    port, ref = both()
    for temp, seed in [(0.0, None), (0.8, None), (1.0, None), (0.0, 7),
                       (0.5, 2**40 + 3), (0.7, None), (0.0, None),
                       (1.2, None)] + [(0.9, None)] * 20:
        assert port._assign_seed(temp, seed) == ref._assign_seed(temp, seed)
    assert port._next_seed == ref._next_seed == 24


def test_admission_shed_equals_ray_tpus(monkeypatch):
    now = 1000.0
    monkeypatch.setattr(time, "monotonic", lambda: now)
    rates = {"cold": (), "one": (now - 3.0,),
             "10/s": tuple(now - 2.0 + i / 10 for i in range(20)),
             "old": tuple(now - 100.0 + i for i in range(20))}
    weights = [{}, {"gold": 4.0, "bronze": 1.0}, {"a": 0.5, "b": 2.0}]
    grid = itertools.product((0, 3, 15, 40, 63, 64, 100), (None, 0, 3),
                             weights, rates.values(),
                             ("gold", "bronze", "a", "-"),
                             (None, now + 0.5, now + 5.0, now - 1.0))
    shed = 0
    for waiting, level, w, admits, tenant, deadline in grid:
        port, ref = both(waiting=waiting, weights=w, level=level,
                         admits=admits)
        got = port._admission_shed(tenant, deadline)
        assert got == ref._admission_shed(tenant, deadline), (
            waiting, level, w, admits, tenant, deadline)
        shed += got is not None
    assert shed > 100  # the grid reaches the deadline and the L3 branches


def test_tenant_turn_equals_ray_tpus():
    tickets = [object() for _ in range(6)]
    states = [
        {"a": (0.0, [0, 1]), "b": (0.0, [2])},
        {"a": (1.5, [0]), "b": (0.25, [2, 3]), "c": (0.25, [4])},
        {"a": (0.0, []), "b": (2.0, [5])},
        {"a": (0.0, []), "b": (0.0, [])},
    ]
    for st in states:
        port, ref = both()
        for s in (port, ref):
            s._tenants = {
                name: {"weight": 1.0, "vtime": vt,
                       "queue": collections.deque(tickets[i] for i in q)}
                for name, (vt, q) in st.items()}
        for tenant, ticket in itertools.product(("a", "b", "c"), tickets):
            assert (port._tenant_turn(tenant, ticket)
                    == ref._tenant_turn(tenant, ticket))


def admission_order(cls, replica_cls, arrivals, weights):
    """Queue `arrivals` (tenant names, in this order) behind a full
    replica, then free one slot at a time: the order of admissions."""
    s = stub_pool(cls, weights=weights)
    rep = replica_cls(None, "decode-1")
    rep.inflight = 1
    s._replicas = [rep]
    order, lock, admitted = [], threading.Lock(), threading.Semaphore(0)

    def client(i, tenant):
        s._acquire(tenant)
        with lock:
            order.append((tenant, i))
        admitted.release()

    threads = []
    for i, tenant in enumerate(arrivals):
        th = threading.Thread(target=client, args=(i, tenant), daemon=True)
        th.start()
        threads.append(th)
        deadline = time.monotonic() + JOIN_S
        while s._waiting < i + 1:  # queued, in arrival order
            assert time.monotonic() < deadline
            time.sleep(0.001)
    for _ in arrivals:
        s._release(rep)
        assert admitted.acquire(timeout=JOIN_S)
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    return order, {t: st["vtime"] for t, st in s._tenants.items()}


@pytest.mark.parametrize("weights", [{}, {"gold": 4.0, "silver": 2.0},
                                     {"gold": 0.5, "bronze": 3.0}])
def test_wfq_admission_order_equals_ray_tpus(weights):
    arrivals = (["bronze"] * 4 + ["gold"] * 4 + ["silver"] * 3
                + ["bronze", "gold"])
    got = admission_order(tpool.LLMPool, tpool._Replica, arrivals, weights)
    want = admission_order(jpool.LLMPool, jpool._Replica, arrivals, weights)
    assert got == want
    assert [t for t, _ in got[0]] != arrivals  # fairness reordered them


def test_error_types_match_ray_tpus():
    for name in ("L0_HEALTHY", "L1_SHED_SPECULATION", "L2_SQUEEZE_BULK",
                 "L3_SHED_ADMISSION", "LEVEL_NAMES"):
        assert getattr(toverload, name) == getattr(joverload, name)
    for cls in ("PoolOverloadedError", "DeadlineExceededError"):
        port = getattr(toverload, cls)("t", "queue_bound", 1.5, level=2)
        ref = getattr(joverload, cls)("t", "queue_bound", 1.5, level=2)
        assert str(port) == str(ref) and port.retryable is ref.retryable
        assert (port.tenant, port.reason, port.retry_after_s, port.level) == (
            ref.tenant, ref.reason, ref.retry_after_s, ref.level)
    assert issubclass(toverload.DeadlineExceededError,
                      toverload.PoolOverloadedError)
    assert hooks.INERT.deadline_error is toverload.DeadlineExceededError


def test_pool_metric_families_are_ray_tpus():
    """The pool's and the shed path's families in hooks.METRIC_FAMILIES
    carry the names, kinds, tag keys and buckets of ray_tpu's own."""
    from ray_tpu.util import metrics as M

    ported = hooks.metric_families(M.Gauge, M.Counter, M.Histogram)
    ref = {**{"pool_" + k: v for k, v in jpool._get_pool_metrics().items()
              if k != "ttft_hist"},
           "ttft": jpool._get_pool_metrics()["ttft_hist"],
           **{k: v for k, v in joverload.get_overload_metrics().items()
              if k != "level"}}
    assert {"pool_replicas", "pool_queue", "pool_ttft_p99", "ttft", "shed",
            "deadline"} == set(ref)
    for key, want in ref.items():
        got = ported[key]
        assert (got.name, got.kind, got.tag_keys, got.description) == (
            want.name, want.kind, want.tag_keys, want.description), key
        assert getattr(got, "boundaries", None) == getattr(
            want, "boundaries", None)
