"""The runtime calls of the serving path, as callables with inert defaults.

The JAX serving code calls into the ray_tpu runtime directly: live config
(``_private/config``), chaos sites (``fault_injection.fire``), flight-
recorder spans, Prometheus-style metrics, the network pacer and byte
accounting, and ``ray_tpu.get`` for weight blobs published through the
object store. The port imports nothing of the runtime, so each of those
calls comes in through a :class:`Hooks` value that the caller builds and
passes (``LLMServer(hooks=...)``, ``PrefillWorker(hooks=...)``,
``RaggedDecoder(hooks=...)``). A hosting runtime wires its own functions
in; the defaults do nothing, except the config pair, which reads and
writes a store local to this process seeded with the runtime's defaults
for the serving knobs.

Signatures (the runtime's own, where it has one):
- ``config_get(key) -> value``; ``config_set(dict)``: live knobs, read by
  the engine at every pump (``serve_spec_enabled``, ``serve_spec_depth``).
- ``fire(site, **ctx) -> action or None``: a chaos site; ``"drop"`` at
  ``serve.spec_verify`` means a plain pump for this chunk. It may raise.
- ``record(kind, name, start_mono, end_mono, *, attrs=None, flush=True)``:
  a completed span, on ``time.monotonic()`` stamps.
- ``metrics() -> dict``: the engine's metric families by key (see
  :data:`METRIC_FAMILIES` and :func:`metric_families`); called per use,
  so it must return the same families each time.
- ``kv_pace(peer, nbytes, owner)``: a kv-class grant on the network pacer
  for a KV handoff; ``kv_account(direction, peer, owner, nbytes,
  tenant)``: its byte accounting, ``direction`` "rx" or "tx".
- ``resolve(blob) -> host tree``: fetch a published weight blob (an
  object-store reference) before it is adopted.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

# the serving knobs of the runtime's config, with its defaults
CONFIG_DEFAULTS = {"serve_spec_enabled": True, "serve_spec_depth": 0}

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
# of the JAX engine, under the same names
TBT_BOUNDARIES = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0)
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


def _no_record(kind, name, start_mono, end_mono, *, attrs=None, flush=True):
    return None


def _no_metrics() -> dict:
    return _INERT_METRICS


def _no_kv_pace(peer, nbytes, owner):
    return None


def _no_kv_account(direction, peer, owner, nbytes, tenant="-"):
    return None


def _identity(blob):
    return blob


@dataclasses.dataclass(frozen=True)
class Hooks:
    """The runtime calls of the serving path; every default is inert."""

    config_get: Callable = config_get
    config_set: Callable = config_set
    fire: Callable = _no_fire
    record: Callable = _no_record
    metrics: Callable = _no_metrics
    kv_pace: Callable = _no_kv_pace
    kv_account: Callable = _no_kv_account
    resolve: Callable = _identity


INERT = Hooks()
