"""Chunked continuous-batching decode engine (ragged KV cache), in PyTorch.

Mirrors ray_tpu/models/decode_engine.py: a fixed SLOT batch over a
static-shape cache with per-slot positions ([B] int32), so every slot
decodes at its own offset and a new stream is admitted into a slot the
moment one frees (at chunk boundaries). Decoding advances `chunk_tokens`
greedy steps per pump; prefill runs per bucketed prompt length into a
temporary cache whose rows then overwrite the whole slot.

The cache tensors are updated IN PLACE (advanced-index writes) where the
JAX version returns new arrays. Invariants kept from the JAX engine:
exactly one device->host transfer per chunk (tokens, pos and pending
first tokens together); pos clamped at max_len - 1; inactive slots hold
their token; admission overwrites all max_len rows of a slot; slot
indices out of range are dropped; the first token's logprob is the
log-softmax at position true_len - 1 (chunk tokens report 0.0).

Greedy only: sampled lanes, speculative decoding, the prefix cache,
externally prefilled streams and metrics export are later slices
(ROADMAP Queue 1). The engine runs without autograd: weights a trainer
publishes (which require grad) build no graph here, as in the JAX engine.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import LlamaConfig


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def init_ragged_cache(cfg: LlamaConfig, slots: int, max_len: int,
                      device=None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
    }


def _layer_decode_ragged(cfg: LlamaConfig, h, p, sin, cos, ck, cv, pos):
    """One-token decode layer with PER-SLOT positions. h: [B, 1, D];
    ck/cv: [B, S, Hkv, D] (written in place); pos: [B]. Writes each slot's
    k/v at its own row and masks attention to k_pos <= pos per slot."""
    b = h.shape[0]
    s = ck.shape[1]
    q, k, v = llama._qkv(cfg, p, h, sin, cos)  # [B, 1, H*, hd]
    rows = torch.arange(b, device=h.device)
    pos_l = pos.long()
    ck[rows, pos_l] = k[:, 0]
    cv[rows, pos_l] = v[:, 0]
    k_pos = torch.arange(s, device=h.device)[None, :]
    live = (k_pos <= pos_l[:, None])[:, None, :]  # [B, 1, S]
    o = llama._masked_cache_attention(cfg, q, ck, cv, live)
    return llama._attn_out_and_mlp(cfg, p, h, o)


@torch.no_grad()
def decode_chunk(params, cache, tok, active, cfg: LlamaConfig, chunk: int):
    """Advance every ACTIVE slot `chunk` greedy tokens.

    tok: [B] current token per slot; active: [B] bool. Inactive slots
    re-write garbage at their frozen pos (invisible: their mask never
    advances; a later prefill overwrites the whole slot). The cache is
    updated in place. Returns ([B, chunk] tokens, cache, [B] last token)."""
    max_len = cache["k"].shape[2]
    w_out = llama._w_out(params, cfg)
    # once per chunk, not per token: the table in the compute dtype (as
    # llama._embed casts it) and the per-layer views
    embed = params["embed"].to(cfg.compute_dtype)
    layers = llama._unbind_layers(params)
    k_all, v_all, pos = cache["k"], cache["v"], cache["pos"]
    step_inc = active.to(pos.dtype)
    t = tok
    toks = []
    for _ in range(chunk):
        sin, cos = llama.rotary_embedding(pos[:, None], cfg.head_dim,
                                          cfg.rope_theta)
        h = embed[t.long()[:, None]]  # [B, 1, D]
        for i, p in enumerate(layers):
            h = _layer_decode_ragged(cfg, h, p, sin, cos, k_all[i], v_all[i],
                                     pos)
        h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
        logits = (h[:, 0] @ w_out).float()  # [B, V]
        nxt = torch.where(active, logits.argmax(dim=-1).to(t.dtype), t)
        # clamp: a slot that exhausts its rows mid-chunk (pump frees slots
        # only at chunk boundaries) keeps writing in range, and the
        # pos >= max_len - 1 finish check stays exact
        pos = torch.clamp(pos + step_inc, max=max_len - 1)
        t = nxt
        toks.append(nxt)
    return (torch.stack(toks, dim=1),
            {"k": k_all, "v": v_all, "pos": pos}, t)


def _greedy_first(last_logits):
    """Greedy token and its log-softmax logprob, per row ([F, V] f32)."""
    toks = last_logits.argmax(dim=-1)
    lp = torch.log_softmax(last_logits, dim=-1).gather(-1, toks[:, None])[:, 0]
    return toks.to(torch.int32), lp


@torch.no_grad()
def _prefill_batch_into_slots(params, prompts, true_lens, slots, cache,
                              cur_tok, cfg: LlamaConfig):
    """Prefill a BATCH of streams ([F, P] right-padded tokens, one bucket
    P) into their slots of the ragged cache. ``slots`` and ``true_lens``
    are host arrays [F]; rows whose slot index lies outside the cache are
    dropped (filtered here: torch has no scatter mode='drop').

    Right-padding is safe without a pad mask: causal attention keeps the
    real prefix from seeing the pad, the first token comes from the TRUE
    last prompt position, and each decode step overwrites a pad row at
    its position before the per-slot mask can expose it.

    FULL-SLOT OVERWRITE: the temporary cache is max_len rows long (zeros
    past the prompt) and replaces ALL rows of each admitted slot, so no
    earlier occupant's k/v survives. Returns (cache, cur_tok, [F] first
    tokens, [F] first-token logprobs), the cache and cur_tok updated in
    place."""
    dev = cache["k"].device
    slots = np.asarray(slots, np.int64)
    true_lens = np.asarray(true_lens, np.int64)
    f = prompts.shape[0]
    n_slots, slot_len = cache["k"].shape[1], cache["k"].shape[2]
    tmp = llama.init_cache(cfg, f, slot_len, device=dev)
    logits, tmp = llama.forward_with_cache(params, prompts, cfg, tmp)
    rows = _to_device(np.arange(f), dev)
    last = logits[rows, _to_device(true_lens - 1, dev)]
    toks0, logp0 = _greedy_first(last)
    keep = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if len(keep):
        keep_d = _to_device(keep, dev)
        slot_d = _to_device(slots[keep], dev)
        cache["k"][:, slot_d] = tmp["k"][:, keep_d]
        cache["v"][:, slot_d] = tmp["v"][:, keep_d]
        cache["pos"][slot_d] = _to_device(true_lens[keep].astype(np.int32), dev)
        cur_tok[slot_d] = toks0[keep_d]
    return cache, cur_tok, toks0, logp0


@dataclass
class _Stream:
    sid: int
    prompt: np.ndarray
    max_new: int
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)  # parallel to tokens
    done: bool = False
    taken: int = 0  # tokens already handed out via take_tokens()
    version: int | None = None  # weight version stamped at admission


class RaggedDecoder:
    """The engine: fixed slot batch + chunked continuous batching.

    submit() enqueues; pump() admits queued streams into free slots
    (prefill) and advances one chunk; finished streams free their slots
    at once. Thread-unsafe by design: ONE pump owner drives it.
    ``params`` must live on ``device`` (default ``cuda``)."""

    def __init__(self, params, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: int = 512, chunk_tokens: int = 32,
                 prompt_buckets: tuple = (32, 64, 128, 256),
                 weights_version: int = 0, device=None):
        self.device = resolve_device(device)
        self._check_params(params)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk_tokens
        self.buckets = tuple(sorted(prompt_buckets))
        self.cache = init_ragged_cache(cfg, slots, max_len, self.device)
        self.cur_tok = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        self.weights_version = int(weights_version)
        self.pumps = 0
        self.slot_stream: list[_Stream | None] = [None] * slots
        self.queue: collections.deque[_Stream] = collections.deque()
        self._next_sid = 0
        self.finished: dict[int, _Stream] = {}
        # (stream, device tok0, device logp0) fetched with the next chunk
        self._pending_first: list = []
        self._by_sid: dict[int, _Stream] = {}
        self._total_tokens = 0
        self._rate_window: collections.deque = collections.deque()

    def _check_params(self, params) -> None:
        got = params["embed"].device
        if torch.device(got.type, got.index or 0) != torch.device(
                self.device.type, self.device.index or 0):
            raise ValueError(f"params live on {got}, engine device is "
                             f"{self.device}")

    # -- submission boundary --

    @torch.no_grad()
    def submit(self, prompt_tokens, max_new: int, *,
               temperature: float = 0.0, top_p: float = 1.0) -> int:
        """Validates HERE (caller's thread) so a bad request raises at the
        submitter, never inside the pump loop. Greedy only: temperature
        > 0 raises NotImplementedError."""
        prompt = np.asarray(prompt_tokens, np.int32)
        self._bucket(len(prompt))  # raises if no bucket fits
        room = self.max_len - len(prompt) - 1
        if room < 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no decode room "
                f"in a max_len={self.max_len} cache")
        if not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if float(temperature) > 0.0:
            raise NotImplementedError(
                f"sampled decoding (temperature={temperature}) is not "
                "ported yet: ROADMAP Queue 1, 'sampled lanes'")
        s = _Stream(self._next_sid, prompt, min(max_new, room))
        self._next_sid += 1
        self.queue.append(s)
        self._by_sid[s.sid] = s
        return s.sid

    def pop_finished(self, sid: int) -> _Stream | None:
        self._by_sid.pop(sid, None)
        return self.finished.pop(sid, None)

    def purge(self, sid: int) -> None:
        """Drop a finished/abandoned stream's bookkeeping."""
        self._by_sid.pop(sid, None)
        self.finished.pop(sid, None)

    def take_tokens(self, sid: int, *, with_logprobs: bool = False):
        """Streaming read: tokens appended since the last take plus a done
        flag (and the parallel logprobs with ``with_logprobs=True``). A
        fully drained finished stream is purged on the way out."""
        s = self._by_sid.get(sid)
        if s is None:
            return ([], [], True) if with_logprobs else ([], True)
        n = len(s.tokens)
        new = s.tokens[s.taken:n]
        lps = s.logprobs[s.taken:n]
        s.taken = n
        done = s.done and s.sid in self.finished
        if done and s.taken >= len(s.tokens):
            self.purge(sid)
        return (new, lps, done) if with_logprobs else (new, done)

    # -- engine internals --

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds the largest "
                         f"bucket {self.buckets[-1]}")

    def _admit(self):
        free = [i for i, s in enumerate(self.slot_stream) if s is None]
        by_bucket: dict[int, list] = {}
        while free and self.queue:
            slot, s = free.pop(), self.queue.popleft()
            s.version = self.weights_version
            by_bucket.setdefault(self._bucket(len(s.prompt)), []).append(
                (slot, s))
        for pb, entries in by_bucket.items():
            f = len(entries)
            prompts = np.zeros((f, pb), np.int32)
            lens = np.ones((f,), np.int32)
            slots_arr = np.zeros((f,), np.int32)
            for i, (slot, s) in enumerate(entries):
                prompts[i, :len(s.prompt)] = s.prompt  # right-pad
                lens[i] = len(s.prompt)
                slots_arr[i] = slot
            (self.cache, self.cur_tok, toks0,
             logp0) = _prefill_batch_into_slots(
                self.params, _to_device(prompts, self.device), lens,
                slots_arr, self.cache, self.cur_tok, self.cfg)
            # no host sync here: first tokens ride the next chunk's fetch
            for i, (slot, s) in enumerate(entries):
                self._pending_first.append((s, toks0[i], logp0[i]))
                self.slot_stream[slot] = s

    @torch.no_grad()
    def pump(self) -> int:
        """Admit + advance one chunk; returns the number of active slots.

        Exactly ONE device->host transfer per chunk: the chunk's tokens,
        per-slot pos and pending first tokens/logprobs travel as one
        int32 buffer (logprobs bit-cast)."""
        self._admit()
        self.pumps += 1
        active_mask = np.array([st is not None for st in self.slot_stream])
        if not active_mask.any():
            return 0
        toks, self.cache, self.cur_tok = decode_chunk(
            self.params, self.cache, self.cur_tok,
            _to_device(active_mask, self.device), self.cfg, self.chunk)
        firsts, self._pending_first = self._pending_first, []
        parts = [toks.reshape(-1).to(torch.int32), self.cache["pos"]]
        if firsts:
            parts.append(torch.stack([t for _, t, _ in firsts]).to(torch.int32))
            parts.append(torch.stack([lp for _, _, lp in firsts])
                         .to(torch.float32).view(torch.int32))
        host = torch.cat(parts).cpu().numpy()
        n_tok = self.slots * self.chunk
        toks_np = host[:n_tok].reshape(self.slots, self.chunk)
        pos_np = host[n_tok:n_tok + self.slots]
        rest = host[n_tok + self.slots:]
        first_toks = rest[:len(firsts)]
        first_lps = rest[len(firsts):].view(np.float32)
        t_now = time.perf_counter()
        delivered = 0
        for (s, _, _), t0, lp0 in zip(firsts, first_toks, first_lps):
            # logprob first, token second: take_tokens slices both lists
            # by len(tokens), so the parallel list must never lag it
            s.logprobs.append(float(lp0))
            s.tokens.append(int(t0))
            delivered += 1
        for slot, s in enumerate(self.slot_stream):
            if s is None:
                continue
            take = max(0, min(self.chunk, s.max_new - len(s.tokens)))
            s.logprobs.extend([0.0] * take)
            s.tokens.extend(int(t) for t in toks_np[slot, :take])
            delivered += take
            if len(s.tokens) >= s.max_new \
                    or int(pos_np[slot]) >= self.max_len - 1:
                s.done = True
                self.finished[s.sid] = s
                self.slot_stream[slot] = None  # slot freed THIS chunk
        self._account(t_now, delivered)
        return int(active_mask.sum())

    def set_params(self, params, version: int) -> None:
        """Adopt new weights at a chunk boundary (pump owner's thread
        only). In-flight streams keep their already-computed KV."""
        self._check_params(params)
        self.params = params
        self.weights_version = int(version)

    RATE_WINDOW_S = 5.0

    def _account(self, t_now: float, delivered: int) -> None:
        self._total_tokens += delivered
        w = self._rate_window
        w.append((t_now, delivered))
        while w and t_now - w[0][0] > self.RATE_WINDOW_S:
            w.popleft()

    def tokens_per_sec(self) -> float:
        w = self._rate_window
        if len(w) < 2:
            return 0.0
        span = w[-1][0] - w[0][0]
        return sum(n for _, n in w) / span if span > 0 else 0.0

    def stats(self) -> dict:
        """Occupancy, queue depth and recent tokens/s."""
        occupancy = [st.sid if st is not None else None
                     for st in self.slot_stream]
        active = sum(1 for st in self.slot_stream if st is not None)
        return {
            "slots": self.slots,
            "active": active,
            "occupancy": occupancy,
            "utilization": active / self.slots if self.slots else 0.0,
            "queued": len(self.queue),
            "tokens_per_sec": round(self.tokens_per_sec(), 1),
            "total_tokens": self._total_tokens,
            "weights_version": self.weights_version,
            "pumps": self.pumps,
        }

    @torch.no_grad()
    def drain(self, deadline_s: float = 600.0) -> None:
        t0 = time.monotonic()
        while self.queue or any(s is not None for s in self.slot_stream):
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError("decode drain exceeded deadline")
            self.pump()
