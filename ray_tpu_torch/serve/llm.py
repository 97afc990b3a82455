"""LLM serving: continuous-batching decode behind a pump thread, in PyTorch.

Mirrors ray_tpu/serve/llm.py. Each server owns a RaggedDecoder
(models/decode_engine.py) and ONE pump thread that does every piece of
device work: admission, prefill, decode chunks, weight swaps. Handler
threads (a hosting runtime calls the server from many at once) only
enqueue under a small lock and wait, so concurrent requests ride the same
slot batch, admitted into free slots at chunk boundaries.

Grad and inference modes and the current CUDA device are thread-local in
PyTorch, so the pump thread sets its device and enters
``torch.inference_mode()`` itself: the server may be built inside or
outside that mode, and its cache written by the pump either way.

The runtime calls of the JAX server (chaos sites, flight-recorder spans,
the network pacer and byte accounting, live config, resolving a weight
blob published through an object store) go through ``serve.hooks.Hooks``;
the port imports nothing of the runtime. A runtime hosts the server as
user code: it builds it (``device="cpu"`` or the card) and passes its own
hooks.

Weight trees (``params_blob`` and ``update_weights``) come either in the
JAX param layout as host arrays, converted by ``llama.from_jax_params``
(one published blob serves both packages), or as the port's own tree of
tensors, taken as they are.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama, mlp
from ray_tpu_torch.models.decode_engine import RaggedDecoder
from ray_tpu_torch.models.kv_prefix_cache import PrefixCache
from ray_tpu_torch.serve import hooks as _hooks

logger = logging.getLogger(__name__)


def model_config(model_size: str, *, max_len: int,
                 vocab_size: int) -> llama.LlamaConfig:
    """The serving config of a named size, as the JAX build_model makes it:
    "tiny" (tests), "tiny-wide" (CPU benches), or a ``llama2_size`` name
    at ``vocab_size`` in bf16."""
    if model_size == "tiny":
        return llama.LlamaConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=max_len, dtype="float32", remat=False)
    if model_size == "tiny-wide":
        return llama.LlamaConfig(
            vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
            d_ff=512, max_seq_len=max_len, dtype="float32", remat=False)
    base = llama.llama2_size(model_size)
    return llama.LlamaConfig(**{**base.__dict__, "vocab_size": vocab_size,
                                "max_seq_len": max_len, "dtype": "bfloat16",
                                "remat": False})


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def adopt_params(tree: dict, cfg: llama.LlamaConfig, device) -> dict:
    """A weight tree as params on `device`: the port's tree of tensors is
    moved there as it is; a host tree in the JAX layout is converted."""
    if isinstance(tree["embed"], torch.Tensor):
        return _tree_to(tree, device)
    return llama.from_jax_params(tree, cfg, device=device)


def build_model(model_size: str = "tiny", *, max_len: int = 512,
                vocab_size: int = 32128, seed: int = 0, params_blob=None,
                device=None, hooks: _hooks.Hooks | None = None):
    """(params, cfg) for a serving model, shared by decode servers and
    prefill workers so both run the identical network. ``params_blob``
    (resolved through ``hooks.resolve`` first) gives the weights; without
    it they are drawn by ``llama.init_params`` from a ``torch.Generator``
    seeded with `seed` on the device. Those differ from the JAX package's
    weights for the same seed (another generator): to serve the same
    network in both, pass the JAX tree (numpy) as the blob. ``device``
    None is ``cuda``, which raises without a card."""
    dev = resolve_device(device)
    if params_blob is not None:
        params_blob = (hooks or _hooks.INERT).resolve(params_blob)
    cfg = model_config(model_size, max_len=max_len, vocab_size=vocab_size)
    if params_blob is not None:
        return adopt_params(params_blob, cfg, dev), cfg
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return llama.init_params(cfg, gen, device=dev), cfg


def build_spec_draft(cfg: llama.LlamaConfig, *, draft_layers: int = 0,
                     draft_head: bool = False, seed: int = 0, device=None):
    """Draft assets for speculative decoding: (draft layer count, head or
    None). The draft is a weight view of the target's first
    `draft_layers` layers (default half the stack); the optional residual
    adapter head (``mlp.init_draft_head``, the identity at init) is drawn
    from a generator seeded with ``seed + 1``. The head is engine-local
    state, never part of the published weight tree."""
    n = int(draft_layers) or max(1, cfg.n_layers // 2)
    n = min(max(n, 1), cfg.n_layers)
    head = None
    if draft_head:
        dev = resolve_device(device)
        head = mlp.init_draft_head(
            cfg.d_model, torch.Generator(device=dev).manual_seed(int(seed) + 1),
            device=dev)
    return n, head


def _pinned(device) -> torch.device:
    """`device` resolved, with the current CUDA index filled in, so the
    pump thread can select it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class LLMServer:
    """A decode replica: build the model on `device`, pump on one thread.

    ``generate`` blocks its handler thread until the stream finishes and
    returns the tokens with their stamps (``submitted_s``,
    ``token_times_s``: ``time.perf_counter()`` on this host), from which a
    caller computes time to first token and time between tokens."""

    STREAM_IDLE_PURGE_S = 120.0  # abandoned streaming sids

    def __init__(self, model_size: str = "tiny", *, slots: int = 8,
                 max_len: int = 512, chunk_tokens: int = 16,
                 vocab_size: int = 32128, seed: int = 0,
                 prompt_buckets: tuple = (32, 64, 128, 256),
                 params_blob=None, prefix_cache_block: int = 0,
                 prefix_cache_mb: int = 256, engine_name: str = "",
                 chunk_delay_s: float = 0.0, weights_version: int = 0,
                 spec_depth: int = 0, spec_draft_layers: int = 0,
                 spec_draft_head: bool = False, device=None,
                 hooks: _hooks.Hooks | None = None):
        self.device = _pinned(device)
        self.hooks = hooks or _hooks.INERT
        params, self.cfg = build_model(
            model_size, max_len=max_len, vocab_size=vocab_size, seed=seed,
            params_blob=params_blob, device=self.device, hooks=self.hooks)
        prefix_cache = None
        if prefix_cache_block > 0:
            prefix_cache = PrefixCache(block=prefix_cache_block,
                                       max_bytes=prefix_cache_mb * 2**20)
        draft_layers, draft_head = build_spec_draft(
            self.cfg, draft_layers=spec_draft_layers,
            draft_head=spec_draft_head, seed=seed, device=self.device)
        self.engine = RaggedDecoder(
            params, self.cfg, slots=slots, max_len=max_len,
            chunk_tokens=chunk_tokens, prompt_buckets=prompt_buckets,
            prefix_cache=prefix_cache, chunk_delay_s=chunk_delay_s,
            name=engine_name or f"llm-{os.getpid()}",
            weights_version=weights_version, spec_depth=spec_depth,
            spec_draft_layers=draft_layers, spec_draft_head=draft_head,
            device=self.device, hooks=self.hooks)
        # (weight tree, version) staged by update_weights(); the pump
        # thread adopts it at the next chunk boundary: engine params are
        # touched only by the pump owner
        self._pending_weights: tuple | None = None
        self._lock = threading.Lock()
        self._done_events: dict[int, threading.Event] = {}
        # sids consumed via poll_stream: the pump must NOT purge their
        # finished entries (no _done_events waiter is registered)
        self._stream_sids: dict[int, float] = {}  # sid -> last poll
        self._stream_ft: set[int] = set()  # sids with first-token span
        # poll RPCs served (single + batched): N streams polled together
        # must cost one, not N
        self._poll_rpcs = 0
        self._stop = False
        self._draining = False
        self._aborted = False
        self._pump_thread = threading.Thread(
            target=self._pump_loop, daemon=True, name="llm-decode-pump")
        self._pump_thread.start()

    def _pump_loop(self):
        # engine state is touched ONLY by this thread; handlers interact
        # through submit (under the small lock) and the finished dict
        # (written here BEFORE the event is set, read by the handler only
        # AFTER it). The pump never holds the lock across device work, so
        # submissions land during a chunk.
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._stop:
                busy = self._pump_once()
                self._release_finished()
                if not busy:
                    time.sleep(0.005)  # idle: don't spin
        if self._aborted:
            # the engine (weights, KV cache, prefix rows) goes with the
            # pump: nothing of a killed replica stays on the device
            self.engine = None

    def _pump_once(self) -> int:
        try:
            # chaos site: replica death / stall mid-decode (ctx carries
            # the engine name so a plan can pin ONE replica)
            self.hooks.fire("serve.replica_pump", engine=self.engine.name)
            with self._lock:
                pending, self._pending_weights = self._pending_weights, None
            if pending is not None:
                tree, version = pending
                self.engine.set_params(
                    adopt_params(tree, self.cfg, self.device), version)
            return self.engine.pump()
        except Exception:  # noqa: BLE001 — the pump must survive:
            # a dead pump thread bricks the replica for every in-flight
            # and future request (submit-time validation rejects bad
            # requests; this is the backstop)
            logger.exception("decode pump error")
            return 0

    def _release_finished(self) -> None:
        now = time.monotonic()
        with self._lock:
            for sid, ev in list(self._done_events.items()):
                if sid in self.engine.finished:
                    ev.set()
            for sid in list(self.engine.finished):
                if sid not in self._done_events \
                        and sid not in self._stream_sids:
                    # abandoned (handler timed out): don't pin the
                    # stream's tokens forever
                    self.engine.purge(sid)
            for sid, last in list(self._stream_sids.items()):
                if now - last > self.STREAM_IDLE_PURGE_S:
                    # streaming client went away mid-stream
                    self._stream_sids.pop(sid, None)
                    self.engine.purge(sid)

    # -- blocking API --

    def _submit_locked(self, submit_fn):
        ev = threading.Event()
        with self._lock:
            if self._draining:
                raise RuntimeError("replica draining: not admitting")
            # submit() validates (prompt fits a bucket, room for a token)
            # and raises HERE, in the handler, never in the pump thread
            sid = submit_fn()
            self._done_events[sid] = ev
        return sid, ev

    def _wait_result(self, sid: int, ev: threading.Event,
                     max_tokens: int) -> dict:
        try:
            if not ev.wait(timeout=600):
                raise TimeoutError(f"stream {sid} did not finish in 600s")
            if self._aborted:
                raise RuntimeError(f"replica aborted with stream {sid} "
                                   f"in flight")
            s = self.engine.pop_finished(sid)
        finally:
            # the timeout path too: a leaked event entry is rescanned
            # every pump; the pump purges finished streams with no waiter
            with self._lock:
                self._done_events.pop(sid, None)
        self._record_token_spans(sid, s, first=True, done=True)
        return {
            "tokens": s.tokens[:max_tokens],
            "submitted_s": s.submitted,
            "token_times_s": s.token_times[:max_tokens],
            "logprobs": s.logprobs[:max_tokens],
            "weights_version": s.version,
        }

    def _record_token_spans(self, sid: int, s, *, first: bool,
                            done: bool) -> None:
        """The ``serve.first_token`` span (submit to first token) and, when
        the stream is done, ``serve.decode`` (first to last token). The
        engine stamps with perf_counter; spans are rebased onto monotonic
        with one paired read."""
        try:
            stamps = s.token_times if s is not None else []
            if not stamps:
                return
            off = time.monotonic() - time.perf_counter()
            if first:
                self.hooks.record(
                    "serve", "serve.first_token", s.submitted + off,
                    stamps[0] + off,
                    attrs={"sid": sid, "engine": self.engine.name})
            if done and len(stamps) > 1:
                self.hooks.record(
                    "serve", "serve.decode", stamps[0] + off,
                    stamps[-1] + off,
                    attrs={"sid": sid, "tokens": len(stamps),
                           "tbt_mean_s": round((stamps[-1] - stamps[0])
                                               / (len(stamps) - 1), 6)})
        except Exception:  # noqa: BLE001 — observability best-effort
            pass

    def generate(self, prompt_ids: list, max_tokens: int = 64, *,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, tenant: str = "-") -> dict:
        """Blocking single-request API (one handler thread per call; all
        calls share the slot batch). Returns {"tokens", "submitted_s",
        "token_times_s", "logprobs", "weights_version"}."""
        sid, ev = self._submit_locked(
            lambda: self.engine.submit(
                list(prompt_ids), int(max_tokens), temperature=temperature,
                top_p=top_p, seed=seed, tenant=tenant))
        return self._wait_result(sid, ev, int(max_tokens))

    def adopt_prefilled(self, kv: dict, prompt_ids: list,
                        max_tokens: int = 64, *, temperature: float = 0.0,
                        top_p: float = 1.0, seed: int = 0,
                        tenant: str = "-") -> dict:
        """Blocking generate for a stream prefilled ELSEWHERE: `kv` is a
        prefill worker's payload (``PrefillWorker.prefill``: KV rows on
        the host and the first token). The rows reach the device at
        admission, on the pump thread."""
        t0 = time.monotonic()
        sid, ev = self._submit_locked(
            lambda: self.engine.submit_prefilled(
                list(prompt_ids), int(max_tokens), kv,
                temperature=temperature, top_p=top_p, seed=seed,
                tenant=tenant))
        self._record_kv_handoff(kv, t0, tenant=tenant)
        return self._wait_result(sid, ev, int(max_tokens))

    def _record_kv_handoff(self, kv, t0: float, tenant: str = "-") -> None:
        """A kv-class pacer grant, the ``serve.kv_handoff`` span and the
        received bytes for an externally prefilled payload this server
        adopts. The grant paces the link; it does not gate correctness
        (the bytes already arrived)."""
        try:
            nb = int(getattr(kv.get("k"), "nbytes", 0)
                     + getattr(kv.get("v"), "nbytes", 0))
            self.hooks.kv_pace("prefill", nb, self.engine.name)
            self.hooks.record("serve", "serve.kv_handoff", t0,
                              time.monotonic(),
                              attrs={"kv_bytes": nb, "tenant": tenant,
                                     "engine": self.engine.name})
            self.hooks.kv_account("rx", "prefill", self.engine.name, nb,
                                  tenant)
        except Exception:  # noqa: BLE001 — observability best-effort
            pass

    # -- streaming API --

    @staticmethod
    def _sampling(req: dict) -> dict:
        return {"temperature": float(req.get("temperature", 0.0)),
                "top_p": float(req.get("top_p", 1.0)),
                "seed": int(req.get("seed", 0))}

    def submit_stream(self, req: dict) -> dict:
        """Start a stream; poll_stream drains it incrementally. `req` may
        carry a prefilled KV payload under "kv" and sampling knobs under
        "temperature"/"top_p"/"seed"."""
        prompt_ids = list(req["prompt_ids"])
        max_tokens = int(req.get("max_tokens", 64))
        sampling = self._sampling(req)
        tenant = str(req.get("tenant", "-"))
        kv = req.get("kv")
        t0 = time.monotonic()
        with self._lock:
            if self._draining:
                raise RuntimeError("replica draining: not admitting")
            if kv is not None:
                sid = self.engine.submit_prefilled(
                    prompt_ids, max_tokens, kv, tenant=tenant, **sampling)
            else:
                sid = self.engine.submit(prompt_ids, max_tokens,
                                         tenant=tenant, **sampling)
            self._stream_sids[sid] = time.monotonic()
        if kv is not None:
            self._record_kv_handoff(kv, t0, tenant=tenant)
        return {"sid": sid}

    def submit_stream_prefilled(self, kv: dict, prompt_ids: list,
                                max_tokens: int = 64, *,
                                temperature: float = 0.0, top_p: float = 1.0,
                                seed: int = 0, tenant: str = "-") -> dict:
        """submit_stream for an externally prefilled stream; `kv` is a
        top-level argument so a runtime can resolve an object-store
        reference to it before the call."""
        return self.submit_stream({
            "prompt_ids": prompt_ids, "max_tokens": max_tokens, "kv": kv,
            "temperature": temperature, "top_p": top_p, "seed": seed,
            "tenant": tenant})

    def poll_stream(self, sid: int) -> dict:
        """New tokens (and their behaviour logprobs) since the last poll,
        the stream's weight version, and a done flag. The final poll
        (done=True) releases the stream."""
        self._poll_rpcs += 1
        return self._poll_one(int(sid))

    def poll_streams(self, sids: list) -> dict:
        """Batched poll: ONE call drains every listed stream, so a caller
        that polls N co-located streams per tick pays one RPC, not N.
        Returns {sid: poll result}."""
        self._poll_rpcs += 1
        return {int(sid): self._poll_one(int(sid)) for sid in sids}

    def _poll_one(self, sid: int) -> dict:
        with self._lock:
            if sid not in self._stream_sids:
                return {"tokens": [], "logprobs": [], "done": True,
                        "version": None}
            self._stream_sids[sid] = time.monotonic()
            # read BEFORE take_tokens: the final (fully drained) take
            # purges the stream and with it the version record
            version = self.engine.stream_version(sid)
            s = self.engine._by_sid.get(sid)
            new, lps, done = self.engine.take_tokens(sid, with_logprobs=True)
            if done:
                self._stream_sids.pop(sid, None)
        first = bool(new) and sid not in self._stream_ft
        if first:
            self._stream_ft.add(sid)
        if done:
            self._stream_ft.discard(sid)
        self._record_token_spans(sid, s, first=first, done=done)
        return {"tokens": new, "logprobs": lps, "done": done,
                "version": version}

    # -- weight publishing --

    def update_weights(self, params_blob, version: int) -> int:
        """Adopt a published weight tree (resolved through
        ``hooks.resolve``). The swap happens on the pump thread at the
        next chunk boundary, so the staleness window is one chunk; this
        returns as soon as the tree is staged."""
        params_blob = self.hooks.resolve(params_blob)
        with self._lock:
            self._pending_weights = (params_blob, int(version))
        return int(version)

    def weights_version(self) -> int:
        return self.engine.weights_version

    def apply_config(self, config: dict) -> dict:
        """Apply live config overrides (``serve_spec_enabled``,
        ``serve_spec_depth``) through ``hooks.config_set``; the engine
        reads them at its next pump. Returns the applied values."""
        self.hooks.config_set(dict(config))
        return {k: self.hooks.config_get(k) for k in config}

    def __call__(self, req: dict) -> dict:
        """HTTP entry point: {"prompt_ids": [...], "max_tokens": N} ->
        generate()."""
        return self.generate(list(req["prompt_ids"]),
                             int(req.get("max_tokens", 64)))

    def stats(self) -> dict:
        with self._lock:
            st = self.engine.stats()
            st["draining"] = self._draining
            st["waiters"] = len(self._done_events)
            st["stream_polls"] = self._poll_rpcs
            return st

    def health(self) -> bool:
        return not self._stop

    # -- lifecycle --

    def shutdown(self, drain_s: float = 30.0) -> bool:
        """Deterministic teardown: reject new admits, let in-flight
        streams finish (bounded by drain_s), then stop and join the pump
        thread. True when everything drained in time and the pump ended."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + max(0.0, drain_s)
        drained = True
        while time.monotonic() < deadline:
            with self._lock:
                busy = (self.engine.queue
                        or any(s is not None for s in self.engine.slot_stream)
                        or self._done_events or self._stream_sids)
            if not busy:
                break
            time.sleep(0.02)
        else:
            drained = False
        self._stop = True
        self._pump_thread.join(timeout=10.0)
        return drained and not self._pump_thread.is_alive()

    def abort(self) -> None:
        """Stop at once, as a killed replica does: no drain. Handlers
        waiting on a stream raise, the pump thread ends after the pump
        under way (it is never joined here, so a caller holding locks of
        its own cannot deadlock on it), and the engine is released as
        it ends."""
        with self._lock:
            self._draining = True
            self._aborted = True
            self._stop = True
            for ev in self._done_events.values():
                ev.set()

    def __del__(self):
        self._stop = True
