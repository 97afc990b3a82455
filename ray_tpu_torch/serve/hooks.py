"""The runtime calls of the serving path, as callables with inert defaults.

The JAX serving code calls into the ray_tpu runtime directly: live config
(``_private/config``), chaos sites (``fault_injection.fire``), flight-
recorder spans and trace context, Prometheus-style metrics, the network
pacer and byte accounting, ``ray_tpu.get`` for weight blobs published
through the object store, the pool's overload guardian and the request's
multiplexed model id. The port imports nothing of the runtime, so each
of those calls comes in through a :class:`Hooks` value that the caller
builds and passes (``LLMPool(hooks=...)``, ``LLMServer(hooks=...)``,
``PrefillWorker(hooks=...)``, ``RaggedDecoder(hooks=...)``). A hosting
runtime wires its own functions in; the defaults do nothing, except the
config pair, which reads and writes a store local to this process seeded
with the runtime's defaults for the serving knobs. (The pool's calls on
its members, ``remote``/``get``/``put``/``kill``, are another value:
``serve.runtime``.)

Signatures (the runtime's own, where it has one):
- ``config_get(key) -> value``; ``config_set(dict)``: live knobs, read by
  the engine at every pump (``serve_spec_enabled``, ``serve_spec_depth``)
  and by the pool (``overload_enabled`` at construction,
  ``overload_shed_queue_bound`` and ``overload_retry_after_min_s`` at
  admission).
- ``fire(site, **ctx) -> action or None``: a chaos site; ``"drop"`` at
  ``serve.spec_verify`` means a plain pump for this chunk, at
  ``overload.shed`` an admission instead of the shed. It may raise.
- ``record(kind, name, start_mono, end_mono, *, attrs=None, trace=None,
  flush=True)``: a completed span, on ``time.monotonic()`` stamps;
  ``trace`` ({"trace_id", "parent"}) overrides the ambient context.
- ``trace``: the trace context, an object with ``root_scope()`` and
  ``scope(trace_id, span)`` (context managers), ``current() -> (trace_id,
  span) or None``, ``new_trace_id()`` and ``new_span_id()``.
- ``metrics() -> dict``: the serving path's metric families by key (see
  :data:`METRIC_FAMILIES` and :func:`metric_families`); called per use,
  so it must return the same families each time.
- ``kv_pace(peer, nbytes, owner)``: a kv-class grant on the network pacer
  for a KV handoff; ``kv_account(direction, peer, owner, nbytes,
  tenant)``: its byte accounting, ``direction`` "rx" or "tx".
  ``bulk_pace`` and ``bulk_account``, the same for bulk-class traffic (a
  weight publish).
- ``resolve(blob) -> host tree``: fetch a published weight blob (an
  object-store reference) before it is adopted.
- ``guardian(pool) -> guardian or None``: the pool's overload guardian,
  an object with ``level`` (0-3; 3 sheds admissions), ``tick()`` (called
  once an autoscale period) and ``state() -> dict``.
- ``model_id() -> str``: the multiplexed model id the current request was
  routed with ("" for the pool's construction model).
- ``overloaded_error``, ``deadline_error``: the classes of a shed and of a
  deadline fast-fail (``serve.overload``'s, or the runtime's own).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

from ray_tpu_torch.serve.overload import DeadlineExceededError, PoolOverloadedError

# the serving knobs of the runtime's config, with its defaults
CONFIG_DEFAULTS = {"serve_spec_enabled": True, "serve_spec_depth": 0,
                   "overload_enabled": True, "overload_shed_queue_bound": 64,
                   "overload_retry_after_min_s": 0.5}

_config: dict = dict(CONFIG_DEFAULTS)
_config_lock = threading.Lock()


def config_get(key: str):
    """The local store's value of a serving knob (KeyError if unknown)."""
    with _config_lock:
        return _config[key]


def config_set(config: dict) -> None:
    """Overwrite knobs of the local store (the process-wide live config,
    as the runtime's ``set_system_config`` is). Unknown keys raise."""
    unknown = set(config) - set(CONFIG_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown config flag(s): {sorted(unknown)}")
    with _config_lock:
        _config.update(config)


def config_reset() -> None:
    """Back to the defaults (for tests that flip knobs)."""
    with _config_lock:
        _config.clear()
        _config.update(CONFIG_DEFAULTS)


# (key, kind, name, description, extra constructor kwargs): the families
# of the JAX engine, pool and overload guardian, under the same names
TBT_BOUNDARIES = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0)
TTFT_BOUNDARIES = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
METRIC_FAMILIES = (
    ("active", "gauge", "decode_engine_active_slots",
     "decode slots currently occupied", {"tag_keys": ("engine",)}),
    ("queued", "gauge", "decode_engine_queue_depth",
     "streams waiting for a free slot", {"tag_keys": ("engine",)}),
    ("tps", "gauge", "decode_engine_tokens_per_sec",
     "tokens/s over the recent window", {"tag_keys": ("engine",)}),
    ("hit_rate", "gauge", "decode_prefix_cache_hit_rate",
     "prefix-cache hit rate since start", {"tag_keys": ("engine",)}),
    ("tbt", "histogram", "serve_tbt_seconds",
     "per-token time-between-tokens (chunk gap / chunk tokens, per active "
     "stream)", {"boundaries": TBT_BOUNDARIES,
                 "tag_keys": ("engine", "tenant")}),
    ("spec_proposed", "counter", "decode_engine_spec_proposed_total",
     "draft tokens proposed to the speculative verify step",
     {"tag_keys": ("engine",)}),
    ("spec_accepted", "counter", "decode_engine_spec_accepted_total",
     "draft tokens accepted by the speculative verify step",
     {"tag_keys": ("engine",)}),
    ("pool_replicas", "gauge", "llm_pool_replicas", "live decode replicas",
     {}),
    ("pool_queue", "gauge", "llm_pool_queue_depth",
     "requests awaiting a replica", {}),
    ("pool_ttft_p99", "gauge", "llm_pool_ttft_p99_s",
     "TTFT p99 over the recent window", {}),
    ("ttft", "histogram", "serve_ttft_seconds",
     "client-observed time to first token (admission wait + "
     "submit->first-token)", {"boundaries": TTFT_BOUNDARIES,
                              "tag_keys": ("tenant",)}),
    ("shed", "counter", "pool_shed_total",
     "admissions refused by the overload guardian",
     {"tag_keys": ("tenant", "reason")}),
    ("deadline", "counter", "pool_deadline_failfast_total",
     "requests fast-failed or reaped for an unmeetable deadline", {}),
)


def metric_families(gauge, counter, histogram) -> dict:
    """Build every family of :data:`METRIC_FAMILIES` with the given
    constructors (``name, description, **kwargs``), keyed as the engine
    reads them. Build once and return the same dict from ``metrics``."""
    kinds = {"gauge": gauge, "counter": counter, "histogram": histogram}
    return {key: kinds[kind](name, desc, **kw)
            for key, kind, name, desc, kw in METRIC_FAMILIES}


class _Inert:
    """A metric family that keeps nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def set(self, value, tags=None):
        pass

    def inc(self, value=1.0, tags=None):
        pass

    def observe(self, value, tags=None):
        pass


_INERT_METRICS = metric_families(_Inert, _Inert, _Inert)


def _no_fire(site: str, **ctx):
    return None


def _no_record(kind, name, start_mono, end_mono, *, attrs=None, trace=None,
               flush=True):
    return None


class NoTrace:
    """A trace context that keeps nothing (the runtime's trace module has
    the same five functions)."""

    @staticmethod
    def root_scope():
        return contextlib.nullcontext()

    @staticmethod
    def scope(trace_id, span):
        return contextlib.nullcontext()

    @staticmethod
    def current():
        return None

    @staticmethod
    def new_trace_id() -> str:
        return ""

    @staticmethod
    def new_span_id() -> str:
        return ""


def _no_metrics() -> dict:
    return _INERT_METRICS


def _no_pace(peer, nbytes, owner):
    return None


def _no_account(direction, peer, owner, nbytes, tenant="-"):
    return None


def _identity(blob):
    return blob


def _no_guardian(pool):
    return None


def _no_model_id() -> str:
    return ""


@dataclasses.dataclass(frozen=True)
class Hooks:
    """The runtime calls of the serving path; every default is inert."""

    config_get: Callable = config_get
    config_set: Callable = config_set
    fire: Callable = _no_fire
    record: Callable = _no_record
    trace: object = NoTrace
    metrics: Callable = _no_metrics
    kv_pace: Callable = _no_pace
    kv_account: Callable = _no_account
    bulk_pace: Callable = _no_pace
    bulk_account: Callable = _no_account
    resolve: Callable = _identity
    guardian: Callable = _no_guardian
    model_id: Callable = _no_model_id
    overloaded_error: type = PoolOverloadedError
    deadline_error: type = DeadlineExceededError


INERT = Hooks()
