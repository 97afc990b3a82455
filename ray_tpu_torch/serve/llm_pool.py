"""The serving pool, in PyTorch: LLMPool and its prefill members.

Mirrors ray_tpu/serve/llm_pool.py. One pool fronts N ``LLMServer``
decode replicas behind a shared admission queue:

    callers ──> LLMPool ──admission queue──> decode replicas
                   │                            ▲
                   └──> prefill workers ──KV────┘

- **Admission.** Weighted fair queueing across tenants (each admission
  advances its tenant's virtual clock by 1/weight), an in-flight cap per
  replica, deadline fast-fail and, at overload level L3, queue-bounded
  shedding with typed retryable errors (``serve.overload``).
- **Replica scaling.** An autoscale loop feeds queue depth, in-flight
  load and the observed TTFT p99 into ``serve_replica_demand`` and
  reconciles the replica set between ``min_replicas`` and
  ``max_replicas``; downscale drains a replica before it is killed.
- **Prefill/decode disaggregation.** Prompts at or above
  ``prefill_threshold`` are prefilled by ``PrefillWorker`` members; the
  KV payload (host tensors: numpy has no bfloat16) is handed to the
  adopting decode replica.
- **One-put weight publishing.** The pool builds the model once, puts
  the host weight tree, and every member adopts the same tree;
  ``publish_weights`` broadcasts a new one, ``wait_version`` waits for
  every replica's engine to swap.
- **Failover.** A replica death re-queues its in-flight requests to
  survivors with no client-visible error: the replacement replays the
  same (seed, position) sampling lanes, and tokens the client already
  has are skipped by offset.
- **Model multiplexing.** ``register_model`` adds weight sets that
  requests select by model id; an LRU keeps the resident ones.

The pool calls its members through a runtime (``serve.runtime``: spawn,
call, get, put, kill; by default members are objects in this process)
and the runtime's other services through ``serve.hooks.Hooks``, so a
hosting runtime can run it over its own actors. ``run_llm_pool`` deploys
a pool through the runtime's ``deploy`` (one replica behind its HTTP
ingress: the in-process runtime's stdlib server, or a hosting runtime's
Serve proxy).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.autoscaler.demand_scheduler import serve_replica_demand
from ray_tpu_torch.models.decode_engine import prefill_kv_sampled
from ray_tpu_torch.serve import hooks as _hooks
from ray_tpu_torch.serve.llm import LLMServer, adopt_params, build_model
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.serve.overload import L3_SHED_ADMISSION
from ray_tpu_torch.serve.runtime import InProcessRuntime, spawn_at_once
from ray_tpu_torch.utils.trees import tree_leaves

logger = logging.getLogger(__name__)

# consumer tags for the pool's two big transfers, for a runtime that
# accounts the pulls behind its calls by consumer
_WEIGHTS_TAGS = {"qos": "bulk", "owner": "weights"}
_KV_TAGS = {"qos": "kv", "owner": "kv-handoff"}


class PrefillWorker:
    """Computes KV rows + the first token of a prompt on `device` (None:
    ``cuda``, which raises without a card) and returns them on the host."""

    def __init__(self, model_size: str = "tiny", *, max_len: int = 512,
                 vocab_size: int = 32128, seed: int = 0,
                 prompt_buckets: tuple = (32, 64, 128, 256),
                 params_blob=None, name: str = "", device=None,
                 hooks: _hooks.Hooks | None = None):
        self.device = resolve_device(device)
        self.hooks = hooks or _hooks.INERT
        self.params, self.cfg = build_model(
            model_size, max_len=max_len, vocab_size=vocab_size, seed=seed,
            params_blob=params_blob, device=self.device, hooks=self.hooks)
        self.max_len = max_len
        self.buckets = tuple(sorted(prompt_buckets))
        self.name = name or f"prefill-{os.getpid()}"
        self._version = 0

    def prefill(self, prompt_ids: list, *, temperature: float = 0.0,
                top_p: float = 1.0, seed: int = 0, tenant: str = "-") -> dict:
        """-> {"k", "v", "first_token", "first_logprob", "true_len",
        "version"}: the payload ``RaggedDecoder.submit_prefilled`` adopts;
        k and v are [n_layers, max_len, n_kv_heads, head_dim] host tensors
        in the compute dtype. The first token rides the stream's (seed,
        position) sampling lane, as an inline prefill's does."""
        # chaos site: prefill-worker death / stall mid-prefill
        self.hooks.fire("serve.prefill", worker=self.name)
        t0 = time.monotonic()
        prompt = np.asarray(prompt_ids, np.int32)
        bucket = next((b for b in self.buckets if len(prompt) <= b), None)
        if bucket is None:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"bucket {self.buckets[-1]}")
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(prompt)] = prompt
        k, v, toks0, logp0 = prefill_kv_sampled(
            self.params, torch.from_numpy(padded), [len(prompt)],
            [int(seed) & 0xFFFFFFFF], [float(temperature)], [float(top_p)],
            self.cfg, self.max_len)
        k, v = k[:, 0].cpu(), v[:, 0].cpu()
        tok0, lp0 = int(toks0[0]), float(logp0[0])
        kv_bytes = int(k.nbytes + v.nbytes)
        try:
            # kv-class pacer grant for the outbound handoff, the span, and
            # the bytes leaving for the adopting decode replica
            self.hooks.kv_pace("decode", kv_bytes, self.name)
            self.hooks.record("serve", "serve.prefill", t0, time.monotonic(),
                              attrs={"worker": self.name, "tenant": tenant,
                                     "prompt_tokens": len(prompt),
                                     "bucket": bucket, "kv_bytes": kv_bytes})
            self.hooks.kv_account("tx", "decode", self.name, kv_bytes, tenant)
        except Exception:  # noqa: BLE001 — observability best-effort
            pass
        return {"k": k, "v": v, "first_token": tok0, "first_logprob": lp0,
                "true_len": len(prompt), "version": self._version}

    def update_weights(self, params_blob, version: int) -> int:
        """Adopt a published weight tree (resolved through
        ``hooks.resolve``), at once: a prefill worker has no pump."""
        self.params = adopt_params(self.hooks.resolve(params_blob), self.cfg,
                                   self.device)
        self._version = int(version)
        return self._version

    def health(self) -> bool:
        return True


def _host_tree(tree):
    """A weight tree on the host: tensors as CPU tensors in their own dtype
    (numpy has no bfloat16), numpy arrays (the JAX layout) as they are."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return np.asarray(tree)


class _Replica:
    """Pool-side record of one decode replica."""

    __slots__ = ("handle", "inflight", "draining", "dead", "name",
                 "poll_lock")

    def __init__(self, handle, name: str):
        self.handle = handle
        self.inflight = 0
        self.draining = False
        self.dead = False
        self.name = name
        # serializes batched stream polls against this replica: one
        # poll_streams call in flight per replica, results for the other
        # co-located streams buffered pool-side
        self.poll_lock = threading.Lock()


class LLMPool:
    """A pool of decode replicas behind one admission queue.

    Takes the JAX pool's arguments, plus ``device`` (None: ``cuda``, which
    raises without a card; every member runs there), ``hooks`` (the
    runtime's services, passed to every member too) and ``runtime`` (how
    members are spawned and called; None: :class:`InProcessRuntime`)."""

    ACQUIRE_TIMEOUT_S = 120.0
    AUTOSCALE_PERIOD_S = 1.0
    TTFT_WINDOW_S = 30.0
    DRAIN_POLL_S = 0.1
    # one spawn wave per cooldown: the TTFT window holds breach samples
    # for up to TTFT_WINDOW_S after a transient spike, and without a
    # cooldown the +1-per-tick SLO rule would ratchet straight to
    # max_replicas before new capacity could absorb anything
    SCALE_UP_COOLDOWN_S = 5.0

    def __init__(self, model_size: str = "tiny", *, slots: int = 8,
                 max_len: int = 512, chunk_tokens: int = 16,
                 vocab_size: int = 32128, seed: int = 0,
                 prompt_buckets: tuple = (32, 64, 128, 256),
                 min_replicas: int = 1, max_replicas: int = 4,
                 target_ttft_s: float | None = None,
                 target_queue_per_replica: float = 4.0,
                 prefill_workers: int = 0,
                 prefill_threshold: int | None = None,
                 prefix_cache_block: int = 0,
                 prefix_cache_mb: int = 256,
                 max_inflight_per_replica: int | None = None,
                 autoscale: bool = True, chunk_delay_s: float = 0.0,
                 tenant_weights: dict | None = None,
                 spec_depth: int = 0, spec_draft_layers: int = 0,
                 spec_draft_head: bool = False,
                 max_resident_models: int = 3,
                 overload_guardian: bool | None = None,
                 device=None, hooks: _hooks.Hooks | None = None,
                 runtime=None):
        self.device = resolve_device(device)
        self.hooks = hooks or _hooks.INERT
        self.runtime = runtime or InProcessRuntime()
        member = dict(device=self.device, hooks=self.hooks)
        self._model_kwargs = dict(
            model_size=model_size, max_len=max_len,
            vocab_size=vocab_size, seed=seed, **member)
        self._replica_kwargs = dict(
            model_size=model_size, slots=slots, max_len=max_len,
            chunk_tokens=chunk_tokens, vocab_size=vocab_size, seed=seed,
            prompt_buckets=tuple(prompt_buckets),
            prefix_cache_block=prefix_cache_block,
            prefix_cache_mb=prefix_cache_mb, chunk_delay_s=chunk_delay_s,
            spec_depth=spec_depth, spec_draft_layers=spec_draft_layers,
            spec_draft_head=spec_draft_head, **member)
        self.slots = slots
        self.min_replicas = max(1, min_replicas)
        self.max_replicas = max(self.min_replicas, max_replicas)
        self.target_ttft_s = target_ttft_s
        self.target_queue_per_replica = target_queue_per_replica
        self.prefill_threshold = prefill_threshold
        self._max_inflight = (max_inflight_per_replica
                              or max(slots * 2, slots + 4))

        # ONE weight build + ONE put; every pool member adopts the tree
        params, _mcfg = build_model(model_size, max_len=max_len,
                                    vocab_size=vocab_size, seed=seed,
                                    device=self.device)
        host_tree = _host_tree(params)
        del params
        self._params_ref = self.runtime.put(host_tree)
        del host_tree

        # model multiplexing: register_model() adds swappable weight sets;
        # requests routed with a model id (an explicit model_id argument,
        # else hooks.model_id()) activate theirs pool-wide through
        # publish_weights. The registry holds host trees; the multiplexed()
        # LRU caches their puts (the resident form), and evicting a model
        # releases its put, re-activating puts it again from the registry.
        self._model_store: dict = {}
        self._base_ref = self._params_ref  # model_id "" stays pinned
        self._active_model = ""
        self._mux_lock = threading.Lock()
        self._resident_ref = multiplexed(
            max_num_models_per_replica=max(1, max_resident_models)
        )(self._put_model)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._replicas: list[_Replica] = []
        self._waiting = 0
        self._n_spawned = 0
        self._ttfts: list = []  # (monotonic stamp, ttft_s, tenant)
        # weighted fair queueing across tenants at the admission queue:
        # each tenant accrues virtual time 1/weight per admission, and the
        # waiting tenant with the LOWEST virtual time goes first (FIFO
        # within a tenant): a tenant flooding the queue advances its own
        # clock, not its turn. Unknown tenants get weight 1.0.
        self._tenant_weights = dict(tenant_weights or {})
        self._tenants: dict[str, dict] = {}
        self._vclock = 0.0
        self._streams: dict[str, dict] = {}
        self._next_rid = 0
        self._last_scale_up = 0.0
        self._stop = False
        # weight-publishing state: version 0 = the construction-time
        # build; publish_weights bumps it and rebroadcasts
        self._weights_version = 0
        self._next_seed = 0
        # overload signals: recent admission stamps (the service rate the
        # deadline predictor divides queue depth by) and a delivered-token
        # window (the tokens/s signal)
        self._admits: collections.deque = collections.deque(maxlen=256)
        self._token_window: collections.deque = collections.deque()
        self.TOKEN_WINDOW_S = 10.0
        guardian_on = (bool(self.hooks.config_get("overload_enabled"))
                       if overload_guardian is None
                       else bool(overload_guardian))
        self._guardian = self.hooks.guardian(self) if guardian_on else None

        rt = self.runtime
        self._replicas.extend(self._spawn_replicas(self.min_replicas))
        rt.get([rt.call(r.handle, "health") for r in self._replicas],
               timeout=600)

        self._prefill: list = []
        if prefill_workers > 0:
            self._prefill = [
                rt.spawn(PrefillWorker, {
                    **self._model_kwargs,
                    "prompt_buckets": tuple(prompt_buckets),
                    "params_blob": self._params_ref,
                    "name": f"prefill-{i + 1}"},
                    name=f"prefill-{i + 1}")
                for i in range(prefill_workers)
            ]
            rt.get([rt.call(p, "health") for p in self._prefill],
                   timeout=600)
            if self.prefill_threshold is None:
                # default: disaggregate the top prompt bucket
                self.prefill_threshold = max(prompt_buckets)
        self._prefill_rr = 0

        if autoscale:
            threading.Thread(target=self._autoscale_loop, daemon=True,
                             name="llm-pool-autoscale").start()

    # ---------- replica lifecycle ----------

    def _spawn_replicas(self, n: int) -> list[_Replica]:
        """``n`` replicas, constructed at the same time, as the JAX pool's
        actors are (a runtime whose ``spawn`` returns once the member is
        built, as the in-process and process runtimes' do, would
        otherwise build them one after another). If one fails, the others
        are killed and its error is raised."""
        # late spawns adopt the LATEST published tree + version; read the
        # pair under the lock: torn against a concurrent publish, a
        # replica could be built on the OLD tree while REPORTING the new
        # version, making wait_version's adoption signal lie
        with self._lock:
            names = [f"decode-{self._n_spawned + i + 1}" for i in range(n)]
            self._n_spawned += n
            ref, version = self._params_ref, self._weights_version
        handles = spawn_at_once(self.runtime, [
            (LLMServer, {**self._replica_kwargs, "params_blob": ref,
                         "engine_name": name, "weights_version": version},
             {"name": name, "max_concurrency": self._max_inflight + 8})
            for name in names])
        return [_Replica(h, name) for h, name in zip(handles, names)]

    def _mark_dead(self, rep: _Replica):
        with self._lock:
            if rep.dead:
                return
            rep.dead = True
            if rep in self._replicas:
                self._replicas.remove(rep)
            self._cond.notify_all()
        logger.warning("llm_pool: replica %s died; %d remain",
                       rep.name, len(self._replicas))

    def _alive(self) -> list[_Replica]:
        return [r for r in self._replicas if not r.dead]

    # ---------- admission ----------

    def _tenant_state(self, tenant: str) -> dict:
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = self._tenants[tenant] = {
                "weight": float(self._tenant_weights.get(tenant, 1.0)),
                "vtime": self._vclock,
                "queue": collections.deque(),
            }
        return ts

    def _tenant_turn(self, tenant: str, ticket) -> bool:
        """Under the lock: is this ticket the head of the waiting tenant
        with the lowest virtual time? (FIFO within a tenant, min-vtime
        across tenants, name tie-break for determinism)."""
        active = [(ts["vtime"], name) for name, ts in self._tenants.items()
                  if ts["queue"]]
        if not active:
            return False
        _, pick = min(active)
        ts = self._tenants[pick]
        return pick == tenant and ts["queue"][0] is ticket

    def _admit_rate_locked(self, now: float) -> float | None:
        """Observed admission service rate (admissions/s over the recent
        window), under the lock. None until enough samples exist: a cold
        pool never fast-fails on a guessed rate."""
        cut = now - self.TTFT_WINDOW_S
        stamps = [t for t in self._admits if t >= cut]
        if len(stamps) < 2 or now - stamps[0] <= 1e-6:
            return None
        return len(stamps) / (now - stamps[0])

    def _admission_shed(self, tenant: str, deadline_abs: float | None):
        """Pre-admission gate: deadline fast-fail (predicted TTFT = queue
        depth x observed service time already over the deadline) and, at
        ladder level L3, queue-bounded shedding: lowest-WFQ-weight tenants
        shed first (their bound scales down with their weight share),
        every tenant sheds at the hard bound. Returns ``None`` (admit) or
        ``(reason, retry_after_s, exc_class)``."""
        now = time.monotonic()
        with self._lock:
            waiting = self._waiting
            rate = self._admit_rate_locked(now)
        predicted = (waiting + 1) / rate if rate else None
        if (deadline_abs is not None and predicted is not None
                and now + predicted > deadline_abs):
            return ("deadline", predicted, self.hooks.deadline_error)
        g = self._guardian
        if g is None or g.level < L3_SHED_ADMISSION:
            return None
        bound = max(1, int(self.hooks.config_get("overload_shed_queue_bound")))
        w = float(self._tenant_weights.get(tenant, 1.0))
        wmax = max([float(v) for v in self._tenant_weights.values()]
                   + [w, 1.0])
        # weight-proportional bound: the lowest-weight tenant sheds from
        # ~bound/4, the highest-weight tenant only at the hard bound
        thresh = bound * (0.25 + 0.75 * (w / wmax))
        if waiting + 1 <= thresh:
            return None
        retry = max(float(self.hooks.config_get("overload_retry_after_min_s")),
                    predicted if predicted is not None else 1.0)
        reason = ("queue_bound" if waiting + 1 > bound
                  else "low_weight")
        return (reason, retry, self.hooks.overloaded_error)

    def _shed(self, tenant: str, reason: str, retry_after: float,
              exc_class) -> None:
        """Refuse one admission, typed: chaos site first (``drop``
        suppresses the shed: the request is admitted anyway), then
        counters, then the retryable error."""
        g = self._guardian
        level = g.level if g is not None else 0
        act = self.hooks.fire("overload.shed", tenant=tenant, reason=reason,
                              level=level)
        if act == "drop":
            return  # injected: skip the shed, admit anyway
        try:
            m = self.hooks.metrics()
            if exc_class is self.hooks.deadline_error:
                m["deadline"].inc()
            m["shed"].inc(tags={"tenant": tenant, "reason": reason})
        except Exception:  # noqa: BLE001 — metrics best-effort
            pass
        raise exc_class(tenant, reason, retry_after, level=level)

    def _acquire(self, tenant: str = "-",
                 deadline_abs: float | None = None,
                 first: bool = True) -> _Replica:
        """Block until some live, non-draining replica has an in-flight
        slot AND it is this tenant's weighted-fair turn. The count of
        blocked handler threads IS the shared admission queue; its depth
        feeds the autoscaler.

        ``deadline_abs`` (monotonic) is the request's client deadline:
        unmeetable-at-admission requests fast-fail typed before queuing
        and queued requests are reaped the moment they expire; neither
        burns a decode slot. ``first=False`` marks a failover re-acquire
        of already-admitted work: it is never shed."""
        if first:
            shed = self._admission_shed(tenant, deadline_abs)
            if shed is not None:
                self._shed(tenant, *shed)
        deadline = time.monotonic() + self.ACQUIRE_TIMEOUT_S
        ticket = object()
        with self._cond:
            self._waiting += 1
            ts = self._tenant_state(tenant)
            # re-align an idle tenant to the current virtual clock: a
            # long-idle tenant must not bank unused past share
            if not ts["queue"]:
                ts["vtime"] = max(ts["vtime"], self._vclock)
            ts["queue"].append(ticket)
            try:
                while True:
                    cands = [r for r in self._replicas
                             if not r.draining and not r.dead
                             and r.inflight < self._max_inflight]
                    if cands and self._tenant_turn(tenant, ticket):
                        rep = min(cands, key=lambda r: r.inflight)
                        rep.inflight += 1
                        ts["queue"].popleft()  # == ticket
                        ts["vtime"] += 1.0 / max(1e-6, ts["weight"])
                        self._vclock = max(self._vclock, ts["vtime"])
                        self._admits.append(time.monotonic())
                        self._cond.notify_all()  # next tenant's turn
                        return rep
                    now = time.monotonic()
                    if deadline_abs is not None and now >= deadline_abs:
                        # expired in the queue: reap it typed (the finally
                        # block removes the ticket)
                        try:
                            self.hooks.metrics()["deadline"].inc()
                        except Exception:  # noqa: BLE001
                            pass
                        rate = self._admit_rate_locked(now)
                        hint = ((self._waiting / rate) if rate
                                else float(self.hooks.config_get(
                                    "overload_retry_after_min_s")))
                        raise self.hooks.deadline_error(
                            tenant, "deadline_expired", hint,
                            level=(self._guardian.level
                                   if self._guardian else 0))
                    wait_until = deadline if deadline_abs is None \
                        else min(deadline, deadline_abs)
                    self._cond.wait(timeout=max(0.0, wait_until - now))
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"no decode replica admitted the request "
                            f"within {self.ACQUIRE_TIMEOUT_S}s "
                            f"({len(self._replicas)} replicas)")
            finally:
                self._waiting -= 1
                if ticket in ts["queue"]:
                    ts["queue"].remove(ticket)  # timeout/interrupt path
                    self._cond.notify_all()

    def _release(self, rep: _Replica):
        with self._cond:
            rep.inflight = max(0, rep.inflight - 1)
            self._cond.notify_all()

    def _record_ttft(self, out: dict, queue_wait_s: float = 0.0,
                     tenant: str = "-"):
        """TTFT as the CLIENT experiences it: pool admission-queue wait
        (monotonic) PLUS the replica-side submit->first-token gap (its
        perf_counter stamps): replica stamps alone are blind to admission
        collapse, the very signal the SLO scaler exists to catch."""
        stamps = out.get("token_times_s") or []
        if stamps and out.get("submitted_s") is not None:
            ttft = queue_wait_s + stamps[0] - out["submitted_s"]
            with self._lock:
                now = time.monotonic()
                self._ttfts.append((now, ttft, tenant))
                cut = now - self.TTFT_WINDOW_S
                while self._ttfts and self._ttfts[0][0] < cut:
                    self._ttfts.pop(0)
            try:
                self.hooks.metrics()["ttft"].observe(ttft, {"tenant": tenant})
            except Exception:  # noqa: BLE001 — metrics best-effort
                pass

    def ttft_p99(self, tenant: str | None = None) -> float | None:
        with self._lock:
            vals = sorted(t for _, t, tn in self._ttfts
                          if tenant is None or tn == tenant)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    def _note_tokens(self, n: int) -> None:
        """Fold delivered tokens into the decode-rate window."""
        if n <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._token_window.append((now, n))
            cut = now - self.TOKEN_WINDOW_S
            while self._token_window and self._token_window[0][0] < cut:
                self._token_window.popleft()

    def tokens_per_s(self) -> float:
        """Pool-wide delivered tokens/s over the recent window."""
        now = time.monotonic()
        with self._lock:
            cut = now - self.TOKEN_WINDOW_S
            total = sum(n for t, n in self._token_window if t >= cut)
        return total / self.TOKEN_WINDOW_S

    # ---------- model multiplexing ----------

    def register_model(self, model_id: str, params) -> None:
        """Register a swappable weight set under ``model_id`` (the pool
        model's tree: the port's tensors, or the JAX layout as numpy). The
        host tree is the registry's source of truth; activation puts it
        (LRU-resident, `max_resident_models`) and broadcasts it to every
        replica through publish_weights."""
        if not model_id:
            raise ValueError("model_id must be non-empty")
        host = _host_tree(params)
        with self._lock:
            self._model_store[model_id] = host

    def _put_model(self, model_id: str):
        """LRU miss path (wrapped by multiplexed() in __init__): put the
        registered host tree."""
        with self._lock:
            host = self._model_store[model_id]
        return self.runtime.put(host)

    def _ensure_model(self, model_id: str | None) -> None:
        """Make the request's model the pool-wide active weights. The id
        comes from the explicit argument, else ``hooks.model_id()``; "" is
        the construction-time model. A switch swaps EVERY replica at its
        next chunk boundary (publish_weights + wait_version); in-flight
        streams of the previous model finish under the mixed-version
        contract of weight publishing, and the version bump makes the
        failover splice guard truncate rather than splice across models.
        Swaps serialize on _mux_lock."""
        mid = (model_id if model_id is not None
               else self.hooks.model_id()) or ""
        if mid == self._active_model:
            return
        with self._mux_lock:
            if mid == self._active_model:
                return
            if mid == "":
                ref = self._base_ref
            else:
                with self._lock:
                    known = mid in self._model_store
                if not known:
                    raise KeyError(
                        f"model {mid!r} is not registered "
                        f"(register_model first)")
                ref = self._resident_ref(mid)
            v = self.publish_weights(ref)
            self.wait_version(v)
            self._active_model = mid

    # ---------- request paths ----------

    def _assign_seed(self, temperature: float, seed) -> int:
        """Per-request seed: the caller's if given, else a pool-assigned
        deterministic lane (greedy requests keep seed 0: it is dead). The
        pool keeps the seed for the request's whole lifetime, so a
        failover re-submit replays the SAME lane; that, plus the engine's
        (seed, position) sampling lanes, keeps replica-death dedup exact
        under sampling."""
        if seed is not None:
            return int(seed)
        if temperature <= 0.0:
            return 0
        with self._lock:
            self._next_seed += 1
            n = self._next_seed
        return (n * 0x9E3779B9) & 0x7FFFFFFF

    def _maybe_prefill(self, prompt_ids: list, sampling: dict | None = None,
                       tenant: str = "-"):
        """Route long prompts to the prefill pool; returns a ref to the KV
        payload, or None for inline prefill."""
        if (not self._prefill or self.prefill_threshold is None
                or len(prompt_ids) < self.prefill_threshold):
            return None
        with self._lock:
            self._prefill_rr += 1
            pw = self._prefill[self._prefill_rr % len(self._prefill)]
        try:
            # NOT resolved here: the ref goes straight into the decode
            # replica's adopt call, which resolves it
            return self.runtime.call(pw, "prefill", list(prompt_ids),
                                     tenant=tenant, **(sampling or {}))
        except Exception:  # noqa: BLE001 — prefill pool degraded:
            return None  # decode replicas prefill inline instead

    def _replica_alive(self, rep: _Replica) -> bool:
        """Cross-check before blaming a replica for an actor error: a dead
        PREFILL worker's error surfaces through the decode replica's adopt
        call (the KV ref resolves there), and marking the healthy decode
        replica dead for it would shrink the pool for nothing. Only actor
        DEATH counts: a probe timeout on a busy replica is slow, not
        dead."""
        rt = self.runtime
        try:
            return bool(rt.get(rt.call(rep.handle, "health"), timeout=10))
        except rt.actor_error:
            return False
        except Exception:  # noqa: BLE001 — slow ≠ dead
            return True

    def generate(self, prompt_ids: list, max_tokens: int = 64, *,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int | None = None, tenant: str = "-",
                 model_id: str | None = None,
                 deadline_s: float | None = None) -> dict:
        """Blocking generate with transparent replica failover, under one
        trace (``hooks.trace``: joined from the ambient context, else
        rooted fresh).

        ``deadline_s`` is the client's TTFT budget from submission: a
        request whose predicted queue wait already exceeds it fast-fails
        typed (``hooks.deadline_error``, retryable) at admission, and one
        that expires while queued is reaped; neither burns a decode
        slot."""
        with self.hooks.trace.root_scope():
            return self._generate_traced(
                prompt_ids, max_tokens, temperature=temperature,
                top_p=top_p, seed=seed, tenant=tenant,
                model_id=model_id, deadline_s=deadline_s)

    def _generate_traced(self, prompt_ids: list, max_tokens: int = 64, *,
                         temperature: float = 0.0, top_p: float = 1.0,
                         seed: int | None = None, tenant: str = "-",
                         model_id: str | None = None,
                         deadline_s: float | None = None) -> dict:
        rt = self.runtime
        self._ensure_model(model_id)
        prompt_ids = list(prompt_ids)
        max_tokens = int(max_tokens)
        tenant = str(tenant)
        sampling = {"temperature": float(temperature),
                    "top_p": float(top_p),
                    "seed": self._assign_seed(float(temperature), seed)}
        kv_ref = self._maybe_prefill(prompt_ids, sampling, tenant)
        last_err: Exception | None = None
        t_enqueue = time.monotonic()
        deadline_abs = (t_enqueue + float(deadline_s)
                        if deadline_s is not None else None)
        for attempt in range(self.max_replicas + 2):
            rep = self._acquire(tenant, deadline_abs, first=(attempt == 0))
            t_admitted = time.monotonic()
            queue_wait = t_admitted - t_enqueue
            self.hooks.record("serve", "serve.admission_wait", t_enqueue,
                              t_admitted, attrs={"replica": rep.name,
                                                 "tenant": tenant,
                                                 "queued": self._waiting})
            try:
                if kv_ref is not None:
                    ref = rt.call(rep.handle, "adopt_prefilled", kv_ref,
                                  prompt_ids, max_tokens, tenant=tenant,
                                  fetch_tags=_KV_TAGS, **sampling)
                else:
                    ref = rt.call(rep.handle, "generate", prompt_ids,
                                  max_tokens, tenant=tenant, **sampling)
                out = rt.get(ref, timeout=600)
                self._record_ttft(out, queue_wait, tenant)
                self._note_tokens(len(out.get("tokens", [])))
                return out
            except rt.actor_error as e:
                last_err = e
                if kv_ref is not None and self._replica_alive(rep):
                    # the PREFILL worker died, not this replica: fall back
                    # to inline prefill on the healthy decode replicas
                    kv_ref = None
                    continue
                # replica died mid-request: re-queue to a survivor; the
                # client never sees this
                self._mark_dead(rep)
                if kv_ref is not None:
                    # the KV payload may have died with the replica:
                    # recompute rather than depend on it
                    kv_ref = self._maybe_prefill(prompt_ids, sampling,
                                                 tenant)
                continue
            finally:
                self._release(rep)
        raise RuntimeError(
            f"request failed over too many dead replicas: {last_err}")

    def __call__(self, req: dict) -> dict:
        dl = req.get("deadline_s")
        return self.generate(
            list(req["prompt_ids"]), int(req.get("max_tokens", 64)),
            temperature=float(req.get("temperature", 0.0)),
            top_p=float(req.get("top_p", 1.0)),
            seed=req.get("seed"),
            tenant=str(req.get("tenant", "-")),
            model_id=req.get("model_id"),
            deadline_s=float(dl) if dl is not None else None)

    # ---------- streaming ----------

    STREAM_TTL_S = 120.0  # abandoned-client purge (frees the replica
    # in-flight slot the stream holds; mirrors LLMServer's sid purge)

    def _sweep_streams(self):
        now = time.monotonic()
        for rid, rec in list(self._streams.items()):
            if now - rec.get("last_poll", now) <= self.STREAM_TTL_S:
                continue
            self._streams.pop(rid, None)
            rep = rec.get("rep")
            if rep is not None:
                self._release(rep)

    def submit_stream(self, req: dict) -> dict:
        self._sweep_streams()
        self._ensure_model(req.get("model_id"))
        prompt_ids = list(req["prompt_ids"])
        max_tokens = int(req.get("max_tokens", 64))
        temperature = float(req.get("temperature", 0.0))
        sampling = {"temperature": temperature,
                    "top_p": float(req.get("top_p", 1.0)),
                    "seed": self._assign_seed(temperature,
                                              req.get("seed"))}
        tenant = str(req.get("tenant", "-"))
        with self._lock:
            self._next_rid += 1
            rid = f"s{self._next_rid}"
        # one trace for the stream's WHOLE lifetime: submit, the prefill
        # worker, the decode replica and every later poll re-enter it
        # (polls are separate calls, so the pair is pinned on the record)
        tr = self.hooks.trace
        trace = tr.current() or (tr.new_trace_id(), tr.new_span_id())
        dl = req.get("deadline_s")
        rec = {"prompt_ids": prompt_ids, "max_tokens": max_tokens,
               "emitted": 0, "rep": None, "sid": None, "done": False,
               "last_poll": time.monotonic(), "sampling": sampling,
               "version": self._weights_version, "trace": trace,
               "tenant": tenant,
               "deadline_abs": (time.monotonic() + float(dl)
                                if dl is not None else None)}
        with tr.scope(*trace):
            rec["kv_ref"] = self._maybe_prefill(prompt_ids, sampling, tenant)
            self._streams[rid] = rec
            try:
                self._assign_stream(rec)
            except BaseException:
                self._streams.pop(rid, None)
                raise
        return {"rid": rid, "seed": sampling["seed"],
                "weights_version": rec["version"]}

    def _assign_stream(self, rec: dict):
        with contextlib.ExitStack() as stack:
            if rec.get("trace"):
                stack.enter_context(self.hooks.trace.scope(*rec["trace"]))
            self._assign_stream_traced(rec)

    def _assign_stream_traced(self, rec: dict):
        rt = self.runtime
        t_enqueue = time.monotonic()
        tenant = rec.get("tenant", "-")
        # only the FIRST assignment is an admission the ladder may shed;
        # failover re-assignments carry already-admitted work
        rep = self._acquire(tenant, rec.get("deadline_abs"),
                            first=not rec.get("was_assigned"))
        rec["was_assigned"] = True
        self.hooks.record("serve", "serve.admission_wait", t_enqueue,
                          time.monotonic(), attrs={"replica": rep.name,
                                                   "tenant": tenant,
                                                   "queued": self._waiting})
        try:
            body = {"prompt_ids": rec["prompt_ids"],
                    "max_tokens": rec["max_tokens"], "tenant": tenant,
                    **rec["sampling"]}
            sid = None
            if rec["kv_ref"] is not None and rec["emitted"] == 0:
                # adopt path only for a fresh stream (the KV ref as a
                # TOP-LEVEL argument, so it resolves on the replica's
                # side); failover restarts re-decode from the prompt
                try:
                    sid = rt.get(rt.call(
                        rep.handle, "submit_stream_prefilled", rec["kv_ref"],
                        rec["prompt_ids"], rec["max_tokens"], tenant=tenant,
                        fetch_tags=_KV_TAGS, **rec["sampling"]),
                        timeout=600)["sid"]
                except rt.actor_error:
                    if self._replica_alive(rep):
                        # the prefill WORKER died, not this replica:
                        # prefill inline here instead
                        rec["kv_ref"] = None
                        sid = None
                    else:
                        self._mark_dead(rep)
                        raise
                except Exception:  # noqa: BLE001 — KV ref unusable:
                    sid = None  # fall through to inline prefill
            if sid is None:
                sid = rt.get(rt.call(rep.handle, "submit_stream", body),
                             timeout=600)["sid"]
            rec["rep"], rec["sid"] = rep, sid
        except rt.actor_error:
            # a replica that died with NO call in flight is only ever
            # discovered on the next request: take it out of rotation so
            # retries land on survivors (and the autoscaler's reap +
            # respawn path sees the true live count)
            self._mark_dead(rep)
            self._release(rep)
            raise
        except BaseException:
            self._release(rep)
            raise

    def poll_stream(self, rid: str) -> dict:
        """One client poll. The replica-side fetch is BATCHED: polling any
        stream drains EVERY stream co-located on its replica in one
        poll_streams call (serialized per replica), and the co-located
        streams' results are buffered on their records for their own next
        poll to return at once. N consumers on one replica cost one call
        per tick, not N."""
        rt = self.runtime
        rec = self._streams.get(rid)
        if rec is None or rec["done"]:
            self._streams.pop(rid, None)
            return {"tokens": [], "logprobs": [], "done": True}
        rec["last_poll"] = time.monotonic()
        ready = rec.get("ready")
        if ready:
            return self._ingest_poll(rid, rec, ready.pop(0),
                                     time.monotonic())
        if rec["rep"] is None:
            # an earlier failover found no survivor yet: keep retrying on
            # every poll instead of surfacing an error (the TTL sweep
            # bounds how long an unassignable stream lingers)
            try:
                self._assign_stream(rec)
            except Exception:  # noqa: BLE001
                return {"tokens": [], "logprobs": [], "done": False,
                        "weights_version": rec["version"]}
        rep = rec["rep"]
        t_poll = time.monotonic()
        with rep.poll_lock:
            # a batch fired by another stream's poll may have buffered our
            # result while we waited on the replica lock
            ready = rec.get("ready")
            if ready:
                return self._ingest_poll(rid, rec, ready.pop(0), t_poll)
            with self._lock:
                batch = [(orid, orec)
                         for orid, orec in self._streams.items()
                         if orec.get("rep") is rep and not orec["done"]
                         and orec.get("sid") is not None]
            sids = [orec["sid"] for _, orec in batch]
            if rec["sid"] not in sids:
                sids.append(rec["sid"])
            try:
                with contextlib.ExitStack() as stack:
                    if rec.get("trace"):
                        stack.enter_context(
                            self.hooks.trace.scope(*rec["trace"]))
                    outs = rt.get(rt.call(rep.handle, "poll_streams", sids),
                                  timeout=120)
            except rt.actor_error:
                return self._failover_poll(rid, rec, rep)
            # fan the batch out: co-located streams consume their buffered
            # result (FIFO per stream: fetches are serialized by the
            # replica lock) on their next poll without a call
            for orid, orec in batch:
                if orid == rid or orec["done"]:
                    continue
                out = outs.get(orec["sid"])
                if out is not None:
                    orec.setdefault("ready", []).append(out)
        out = outs.get(rec["sid"]) or {"tokens": [], "logprobs": [],
                                       "done": False, "version": None}
        return self._ingest_poll(rid, rec, out, t_poll)

    def _failover_poll(self, rid: str, rec: dict, rep: _Replica) -> dict:
        """Mid-stream replica death discovered by a poll: re-queue onto a
        survivor and skip the tokens the client already has; exact
        because the replacement replays the same (seed, position) lanes
        against the same weight version. If weights were republished
        since the stream started AND tokens are already out, a replay
        would continue under another policy; splicing that onto the
        emitted prefix would hand the client a sequence no single policy
        produced, so the stream closes at the emitted prefix instead
        (``truncated``)."""
        self._mark_dead(rep)
        self._release(rep)
        rec["rep"] = rec["sid"] = None
        if rec["emitted"] > 0 and rec["version"] != self._weights_version:
            rec["done"] = True
            self._streams.pop(rid, None)
            return {"tokens": [], "logprobs": [], "done": True,
                    "truncated": True,
                    "weights_version": rec["version"]}
        rec["replayed"] = 0  # replacement stream replays from 0
        if rec["emitted"] == 0:
            # nothing delivered: free to restart under the current version
            rec["version"] = self._weights_version
        try:
            self._assign_stream(rec)
        except Exception:  # noqa: BLE001 — retried next poll
            pass
        return {"tokens": [], "logprobs": [], "done": False,
                "weights_version": rec["version"]}

    def _ingest_poll(self, rid: str, rec: dict, out: dict,
                     t_poll: float) -> dict:
        """Fold one replica-side poll result (live or buffered) into the
        stream record: version pinning, failover offset dedup, the
        stream-poll span, and release-on-done."""
        # pin the stream's version to the ENGINE version its tokens are
        # generated under: a stream submitted inside the publish-to-
        # adoption window carries the pool's NEW publish stamp while a
        # lagging replica still decodes it under the old weights
        v_eng = out.get("version")
        if v_eng is not None and rec["emitted"] == 0:
            rec["version"] = v_eng
        new = out["tokens"]
        lps = out.get("logprobs", [])
        skip = 0
        # after failover the replacement stream replays from token 0
        if rec.get("replayed", 0) < rec["emitted"]:
            skip = min(len(new), rec["emitted"] - rec.get("replayed", 0))
            rec["replayed"] = rec.get("replayed", 0) + skip
        fresh = new[skip:]
        fresh_lps = lps[skip:] if lps else []
        self._note_tokens(len(fresh))
        rec["emitted"] += len(fresh)
        rec["replayed"] = rec.get("replayed", 0) + len(fresh)
        if fresh or out["done"]:
            tr = rec.get("trace")
            self.hooks.record(
                "serve", "serve.stream_poll", t_poll, time.monotonic(),
                attrs={"rid": rid, "tokens": len(fresh),
                       "tenant": rec.get("tenant", "-"),
                       "done": bool(out["done"])},
                trace=({"trace_id": tr[0], "parent": tr[1]} if tr else None))
        if out["done"]:
            rec["done"] = True
            rep = rec.get("rep")
            if rep is not None:
                self._release(rep)
            self._streams.pop(rid, None)
        return {"tokens": fresh, "logprobs": fresh_lps, "done": out["done"],
                "weights_version": rec["version"]}

    # ---------- weight publishing (actor-learner loop) ----------

    def publish_weights(self, params, version: int | None = None,
                        timeout: float = 120.0) -> int:
        """ONE-put weight broadcast: ``params`` is a host tree (put once
        here: the port's tensors, or the JAX layout as numpy) or a ref
        already put; every decode replica and prefill worker adopts the
        SAME ref. Replicas swap at their next chunk boundary (the bounded
        staleness window), and replicas spawned later adopt this ref at
        construction. Returns the published version."""
        rt = self.runtime
        if not rt.is_ref(params):
            # weight blobs are BULK traffic: claim a bulk-class grant
            # sized to the tree before the put fans out, and account it
            try:
                nbytes = sum(int(getattr(leaf, "nbytes", 0))
                             for leaf in tree_leaves(params))
                if nbytes > 0:
                    self.hooks.bulk_pace("serve-pool", nbytes, "weights")
                    self.hooks.bulk_account("tx", "serve-pool", "weights",
                                            nbytes)
            except Exception:  # noqa: BLE001 — accounting best-effort
                pass
            params = rt.put(params)
        with self._lock:
            version = int(version) if version is not None \
                else self._weights_version + 1
            self._weights_version = version
            self._params_ref = params
            reps = [r for r in self._replicas if not r.dead]
            pws = list(self._prefill)
        # fire ALL updates first, gather after: members pull the tree
        # concurrently, so the staleness window stays ~one pull
        rep_refs = []
        for r in reps:
            try:
                rep_refs.append((r, rt.call(r.handle, "update_weights",
                                            params, version,
                                            fetch_tags=_WEIGHTS_TAGS)))
            except Exception:  # noqa: BLE001
                rep_refs.append((r, None))
        pw_refs = []
        for p in pws:
            try:
                pw_refs.append(rt.call(p, "update_weights", params, version,
                                       fetch_tags=_WEIGHTS_TAGS))
            except Exception:  # noqa: BLE001
                pass
        for r, ref in rep_refs:
            try:
                if ref is not None:
                    rt.get(ref, timeout=timeout)
            except rt.actor_error:
                self._mark_dead(r)  # discovered dead on the broadcast
            except Exception:  # noqa: BLE001 — a dying member misses
                pass  # this version; failover/respawn re-adopts latest
        for ref in pw_refs:
            try:
                rt.get(ref, timeout=timeout)
            except Exception:  # noqa: BLE001
                pass
        return version

    def wait_version(self, version: int, timeout: float = 60.0) -> bool:
        """Block until every live replica's ENGINE reports >= version (the
        pump swapped, not merely staged): the publish-to-adoption
        probe."""
        rt = self.runtime
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                reps = [r for r in self._replicas if not r.dead]
            vs = []
            ok = True
            for r in reps:
                try:
                    vs.append(rt.get(rt.call(r.handle, "weights_version"),
                                     timeout=10))
                except rt.actor_error:
                    # a silently-dead replica must not make every publish
                    # wait out the full adoption deadline
                    self._mark_dead(r)
                except Exception:  # noqa: BLE001 — churn: retry
                    ok = False
            if ok and vs and all(v >= version for v in vs):
                return True
            time.sleep(0.01)
        return False

    # ---------- autoscaling ----------

    def _autoscale_loop(self):
        while not self._stop:
            time.sleep(self.AUTOSCALE_PERIOD_S)
            try:
                self._autoscale_once()
            except Exception:  # noqa: BLE001
                if not self.runtime.is_initialized():
                    return  # runtime gone: the pool is history
                logger.exception("llm_pool autoscale tick failed")

    def _reap_dead(self):
        """Health-probe the replica set: a replica that died with no
        request in flight is otherwise discovered only when a request
        lands on it; the autoscale tick probes so the pool heals back to
        min_replicas proactively."""
        rt = self.runtime
        with self._lock:
            reps = [r for r in self._replicas if not r.dead]
        for r in reps:
            try:
                rt.get(rt.call(r.handle, "health"), timeout=10)
            except rt.actor_error:
                self._mark_dead(r)
            except Exception:  # noqa: BLE001 — slow ≠ dead
                pass

    def _autoscale_once(self):
        rt = self.runtime
        self._sweep_streams()
        self._reap_dead()
        with self._lock:
            n = len([r for r in self._replicas if not r.draining])
            waiting = self._waiting
            inflight = sum(r.inflight for r in self._replicas)
        ttft = self.ttft_p99()
        desired = serve_replica_demand(
            queue_depth=waiting, inflight=inflight, n_replicas=n,
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            target_queue_per_replica=self.target_queue_per_replica,
            ttft_p99_s=ttft, target_ttft_s=self.target_ttft_s)
        try:
            m = self.hooks.metrics()
            m["pool_replicas"].set(n)
            m["pool_queue"].set(waiting)
            if ttft is not None:
                m["pool_ttft_p99"].set(ttft)
        except Exception:  # noqa: BLE001
            pass
        if self._guardian is not None:
            # the brownout ladder rides the same cadence as scaling
            self._guardian.tick()
        if desired > n:
            if (time.monotonic() - self._last_scale_up
                    < self.SCALE_UP_COOLDOWN_S):
                return
            fresh = self._spawn_replicas(desired - n)
            try:
                rt.get([rt.call(r.handle, "health") for r in fresh],
                       timeout=600)
            except Exception:  # noqa: BLE001 — reap, retry next tick
                for r in fresh:
                    try:
                        rt.kill(r.handle)
                    except Exception:  # noqa: BLE001
                        pass
                raise
            with self._cond:
                self._replicas.extend(fresh)
                self._cond.notify_all()
                cur_ref, cur_v = self._params_ref, self._weights_version
            # close the spawn/publish race: a publish that landed while
            # these replicas were constructing missed them (they were not
            # in _replicas yet): re-send the latest tree; a replica
            # already current ignores the re-stage
            if cur_v > 0:
                for r in fresh:
                    try:
                        rt.call(r.handle, "update_weights", cur_ref, cur_v,
                                fetch_tags=_WEIGHTS_TAGS)
                    except Exception:  # noqa: BLE001
                        pass
            self._last_scale_up = time.monotonic()
            logger.info("llm_pool: scaled up to %d replicas",
                        len(self._replicas))
        elif desired < n:
            self._drain_one()

    def _drain_one(self):
        rt = self.runtime
        with self._lock:
            cands = [r for r in self._replicas
                     if not r.draining and not r.dead]
            if len(cands) <= self.min_replicas:
                return
            victim = min(cands, key=lambda r: r.inflight)
            victim.draining = True  # no new admissions

        def _drain():
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and victim.inflight > 0:
                time.sleep(self.DRAIN_POLL_S)
            try:
                # deterministic teardown (LLMServer.shutdown): finish
                # in-flight decode, stop the pump thread
                rt.get(rt.call(victim.handle, "shutdown", 30.0), timeout=60)
            except Exception:  # noqa: BLE001 — dead already
                pass
            with self._lock:
                if victim in self._replicas:
                    self._replicas.remove(victim)
            try:
                rt.kill(victim.handle)
            except Exception:  # noqa: BLE001
                pass
            logger.info("llm_pool: drained + retired %s (now %d)",
                        victim.name, len(self._replicas))

        threading.Thread(target=_drain, daemon=True,
                         name="llm-pool-drain").start()

    # ---------- introspection / lifecycle ----------

    def stats(self) -> dict:
        rt = self.runtime
        with self._lock:
            reps = list(self._replicas)
            waiting = self._waiting
        per_replica = {}
        for r in reps:
            try:
                per_replica[r.name] = rt.get(rt.call(r.handle, "stats"),
                                             timeout=30)
            except Exception as e:  # noqa: BLE001
                per_replica[r.name] = {"error": str(e)[:100]}
        agg_tps = sum(s.get("tokens_per_sec", 0.0)
                      for s in per_replica.values()
                      if isinstance(s, dict))
        pc = [s["prefix_cache"] for s in per_replica.values()
              if isinstance(s, dict) and s.get("prefix_cache")]
        hits = sum(p["hits"] for p in pc)
        total = hits + sum(p["misses"] for p in pc)
        with self._lock:
            tenants = sorted({tn for _, _, tn in self._ttfts})
        return {
            "replicas": len(reps),
            "queue_depth": waiting,
            "inflight": sum(r.inflight for r in reps),
            "tokens_per_sec": round(agg_tps, 1),
            "ttft_p99_s": self.ttft_p99(),
            "ttft_p99_by_tenant": {tn: self.ttft_p99(tn)
                                   for tn in tenants},
            "prefill_workers": len(self._prefill),
            "prefix_cache_hit_rate": (hits / total) if total else None,
            "weights_version": self._weights_version,
            "active_model": self._active_model,
            "registered_models": sorted(self._model_store),
            "resident_models": list(self._resident_ref._cache),
            "per_replica": per_replica,
            "tokens_per_s_window": round(self.tokens_per_s(), 1),
            "overload": (self._guardian.state()
                         if self._guardian is not None else None),
        }

    def health(self) -> bool:
        return not self._stop

    def shutdown(self) -> bool:
        rt = self.runtime
        self._stop = True
        with self._lock:
            reps = list(self._replicas)
            self._replicas = []
        for r in reps:
            try:
                rt.get(rt.call(r.handle, "shutdown", 5.0), timeout=30)
            except Exception:  # noqa: BLE001
                pass
            try:
                rt.kill(r.handle)
            except Exception:  # noqa: BLE001
                pass
        for p in self._prefill:
            try:
                rt.kill(p)
            except Exception:  # noqa: BLE001
                pass
        self._prefill = []
        return True


def run_llm_pool(name: str = "llm", *, runtime,
                 route_prefix: str | None = None,
                 max_concurrent_queries: int = 128, **pool_kwargs):
    """Deploy an LLMPool through ``runtime`` (``serve.runtime``'s
    ``deploy``: HTTP-routable at ``route_prefix``, default ``/{name}``)
    and return its handle; ``runtime.http_address()`` is the ingress. The
    pool's own members come through the same runtime unless
    ``pool_kwargs`` name one. min_replicas/max_replicas/target_ttft_s go
    to the POOL (init kwargs): the pool scales its own decode replicas.
    The pool deployment itself stays at ONE replica — NEVER give it
    deployment-level autoscaling (a second pool replica would split the
    admission queue, duplicate the decode fleet, and break
    submit_stream/poll_stream affinity across pool instances)."""
    pool_kwargs.setdefault("runtime", runtime)
    return runtime.deploy(
        LLMPool, name=name, route_prefix=route_prefix or f"/{name}",
        init_kwargs=pool_kwargs, num_replicas=1,
        max_concurrent_queries=max_concurrent_queries)
