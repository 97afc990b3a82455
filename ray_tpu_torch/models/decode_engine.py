"""Chunked continuous-batching decode engine (ragged KV cache), in PyTorch.

Mirrors ray_tpu/models/decode_engine.py: a fixed SLOT batch over a
static-shape cache with per-slot positions ([B] int32), so every slot
decodes at its own offset and a new stream is admitted into a slot the
moment one frees (at chunk boundaries). A pump advances `chunk_tokens`
steps; prefill runs per bucketed prompt length, at the static width of
the slot batch, into a temporary cache whose rows then overwrite the
whole slot.

Every request kind of the JAX engine is served:
- greedy and sampled streams: a stream with temperature > 0 samples on
  its (seed, position) RNG lane (``_sample_from_logits``, the port of
  ``jax.random`` in ``utils/prng.py``) with top-p filtering, and reports
  the behaviour logprob of every token;
- speculative decoding (``decode_chunk_spec``): the target's first
  layers draft K tokens, one K+1-wide verify accepts them up to the
  first mismatch;
- the block prefix cache (``models/kv_prefix_cache.py``): a warm
  admission adopts cached prefix rows and prefills only the suffix;
- disaggregated prefill: ``prefill_kv``/``prefill_kv_sampled`` run
  elsewhere, ``submit_prefilled`` adopts their KV rows into a slot.

The cache tensors are updated IN PLACE (advanced-index writes) where the
JAX version returns new arrays. Invariants kept from the JAX engine:
exactly one device->host transfer per pump (tokens, logprobs, counts,
pos and pending first tokens together); pos clamped at max_len - 1;
inactive slots hold their token; admission overwrites all max_len rows
of a slot; slot indices out of range are dropped; a greedy-only engine
reports logprob 0.0 for chunk tokens, and after the first sampled submit
every token carries its logprob. The engine runs without autograd:
weights a trainer publishes (which require grad) build no graph here.

Every stream carries its submit stamp and one stamp per token
(``time.perf_counter()``, taken when the tokens reached the host), from
which the serving wrappers report time to first token and time between
tokens. The runtime calls of the JAX engine (live spec config, the
``serve.spec_verify`` chaos site, the speculative pump's span, the
metric families) go through the injected ``serve.hooks.Hooks``.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama, mlp
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.serve import hooks as _hooks
from ray_tpu_torch.utils import prng


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _fetch(parts: list) -> list:
    """ONE device->host transfer for several int32/f32 tensors: flattened
    into one int32 buffer (f32 bit-cast), split back into numpy arrays of
    their shapes and dtypes."""
    flat = [p.reshape(-1).view(torch.int32) if p.dtype == torch.float32
            else p.reshape(-1).to(torch.int32) for p in parts]
    host = torch.cat(flat).cpu().numpy()
    out, i = [], 0
    for p in parts:
        a = host[i:i + p.numel()].reshape(p.shape)
        i += p.numel()
        out.append(a.view(np.float32) if p.dtype == torch.float32 else a)
    return out


def _host_rows(rows) -> torch.Tensor:
    """KV rows given as a tensor (kept) or an array (copied: a read-only
    array, as JAX hands out, cannot back a tensor)."""
    return rows if isinstance(rows, torch.Tensor) else torch.from_numpy(
        np.array(rows))


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


def _verify_index(pos, t: int, max_len: int):
    """Index tensors of a T-wide verify at base positions pos [B], shared
    by every layer: (rows [B, 1]; src, dst [B, T]: query j's k/v row goes
    to cache row dst = pos + src; live [B, T, S]: query j sees k_pos <=
    pos + j).

    JAX's scatter DROPS the writes of queries past the cache end (pos + j
    >= max_len); a torch index there raises. Here such a query writes the
    row of the last in-range query instead (src clamped to max_len - 1 -
    pos), so a duplicated index always carries identical values and the
    write stays deterministic. Its mask is left unclamped, as JAX's is."""
    b = pos.shape[0]
    dev = pos.device
    pos_l = pos.long()[:, None]
    j = torch.arange(t, device=dev)[None, :]
    src = torch.minimum(j, max_len - 1 - pos_l)
    k_pos = torch.arange(max_len, device=dev)[None, None, :]
    live = k_pos <= (pos_l + j)[:, :, None]
    return torch.arange(b, device=dev)[:, None], src, pos_l + src, live


def _layer_verify_ragged(cfg: LlamaConfig, h, p, sin, cos, ck, cv, idx):
    """T-query generalisation of :func:`_layer_decode_ragged` for the
    speculative VERIFY step: h is [B, T, D] (the current token plus the K
    drafted tokens), ``idx`` from :func:`_verify_index`. All T k/v rows
    are written at pos..pos+T-1 (in place, past-the-end rows dropped) and
    the mask is per-query causal, so the wide pass computes the T
    sequential ragged-decode steps in one layer sweep."""
    rows, src, dst, live = idx
    q, k, v = llama._qkv(cfg, p, h, sin, cos)  # [B, T, H*, hd]
    ck[rows, dst] = k[rows, src]
    cv[rows, dst] = v[rows, src]
    o = llama._masked_cache_attention(cfg, q, ck, cv, live)
    return llama._attn_out_and_mlp(cfg, p, h, o)


# --------------------------------------------------------------------------
# Sampling lanes
# --------------------------------------------------------------------------

def _nucleus(logits, temps, top_ps):
    """Temperature-scaled logits with the tokens outside each row's top-p
    nucleus set to -inf. The order is a STABLE argsort of -scaled (as
    jnp.argsort), and the exclusive cumsum keeps at least the top token
    even for a tiny top_p."""
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    probs = torch.softmax(scaled.gather(-1, order), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, scaled, float("-inf"))


def sample_scores(logits, seeds, pos, temps, top_ps):
    """Per row, the scores whose argmax is its token, and the vector whose
    log-softmax gives the token's logprob: for temperature > 0, the
    nucleus-filtered scaled logits plus the Gumbel noise of the (seed,
    pos) lane, and the filtered logits; for temperature 0, the logits,
    twice. logits [B, V] f32; seeds, pos [B] int; temps, top_ps [B] f32."""
    filt = _nucleus(logits, temps, top_ps)
    keys = prng.fold_in(prng.prng_key(seeds), pos)
    noise = prng.gumbel(keys, logits.shape[-1:])
    use = (temps > 0.0)[:, None]
    return (torch.where(use, filt + noise, logits),
            torch.where(use, filt, logits))


def _sample_from_logits(logits, seeds, pos, temps, top_ps):
    """Per-slot stateless sampling lane: the RNG key of the token emitted
    from position `pos` of a stream is fold_in(PRNGKey(seed), pos), a pure
    function of (request seed, position), independent of slot index,
    batch composition and admission timing, which makes seed replay exact.

    Temperature 0 selects the greedy token (the plain argmax), its logprob
    under the unscaled distribution. Otherwise the token is the argmax of
    the filtered logits plus TOKEN-space Gumbel noise (the noise of token
    v is a function of (key, v)), so a speculative draft that samples on
    the same lane agrees with the target whenever their distributions are
    close. Returns ([B] int32 tokens, [B] f32 logprobs under the ACTUAL
    sampling distribution, temperature-scaled and top-p-renormalised: the
    behaviour policy an RL learner importance-corrects against)."""
    scores, dist = sample_scores(logits, seeds, pos, temps, top_ps)
    tok = scores.argmax(dim=-1)
    lp = torch.log_softmax(dist, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), lp


def _pick(logits, lanes, pos):
    """Token and logprob per row: the argmax (logprob None) for a
    greedy-only engine (``lanes`` None), else the sampling lanes (seeds,
    temps, top_ps) at positions ``pos``."""
    if lanes is None:
        return logits.argmax(dim=-1).to(torch.int32), None
    return _sample_from_logits(logits, lanes[0], pos, lanes[1], lanes[2])


# --------------------------------------------------------------------------
# Decode chunks
# --------------------------------------------------------------------------

def _weights(params, cfg: LlamaConfig):
    """Once per chunk, not per token: the embedding table in the compute
    dtype (as llama._embed casts it), the per-layer views, the unembedding."""
    return (params["embed"].to(cfg.compute_dtype), llama._unbind_layers(params),
            llama._w_out(params, cfg))


def _step_logits(cfg: LlamaConfig, params, weights, t, k_all, v_all, pos,
                 n_layers=None, head=None):
    """One ragged decode step over the first ``n_layers`` layers (all when
    None), with the draft head ``head`` applied before the final norm:
    writes each slot's k/v at its pos and returns [B, V] f32 logits."""
    embed, layers, w_out = weights
    sin, cos = llama.rotary_embedding(pos[:, None], cfg.head_dim,
                                      cfg.rope_theta)
    h = embed[t.long()[:, None]]  # [B, 1, D]
    for i, p in enumerate(layers[:n_layers]):
        h = _layer_decode_ragged(cfg, h, p, sin, cos, k_all[i], v_all[i], pos)
    h = mlp.apply_draft_head(head, h)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    return (h[:, 0] @ w_out).float()


@torch.no_grad()
def decode_chunk(params, cache, tok, active, cfg: LlamaConfig, chunk: int):
    """Advance every ACTIVE slot `chunk` greedy tokens.

    tok: [B] current token per slot; active: [B] bool. Inactive slots
    re-write garbage at their frozen pos (invisible: their mask never
    advances; a later prefill overwrites the whole slot). The cache is
    updated in place. Returns ([B, chunk] tokens, cache, [B] last token)."""
    toks, _, cache, t = decode_chunk_sampled(params, cache, tok, active, None,
                                             None, None, cfg, chunk)
    return toks, cache, t


@torch.no_grad()
def decode_chunk_sampled(params, cache, tok, active, seeds, temps, top_ps,
                         cfg: LlamaConfig, chunk: int):
    """`decode_chunk` with per-slot sampling lanes and per-token logprobs:
    seeds [B] int, temps/top_ps [B] f32; a slot at temperature 0 decodes
    greedily (the argmax). ``seeds`` None: a greedy-only engine (argmax,
    no logprobs). Returns ([B, chunk] tokens, [B, chunk] f32 logprobs or
    None, cache, [B] last token)."""
    max_len = cache["k"].shape[2]
    weights = _weights(params, cfg)
    lanes = None if seeds is None else (seeds, temps, top_ps)
    k_all, v_all, pos = cache["k"], cache["v"], cache["pos"]
    step_inc = active.to(pos.dtype)
    t = tok
    toks, lps = [], []
    for _ in range(chunk):
        logits = _step_logits(cfg, params, weights, t, k_all, v_all, pos)
        nxt, lp = _pick(logits, lanes, pos)
        nxt = torch.where(active, nxt.to(t.dtype), t)
        # clamp: a slot that exhausts its rows mid-chunk (pump frees slots
        # only at chunk boundaries) keeps writing in range, and the
        # pos >= max_len - 1 finish check stays exact
        pos = torch.clamp(pos + step_inc, max=max_len - 1)
        t = nxt
        toks.append(nxt)
        lps.append(lp)
    return (torch.stack(toks, dim=1),
            None if lanes is None else torch.stack(lps, dim=1),
            {"k": k_all, "v": v_all, "pos": pos}, t)


@torch.no_grad()
def decode_chunk_spec(params, draft_head, cache, tok, active, seeds, temps,
                      top_ps, cfg: LlamaConfig, rounds: int, depth: int,
                      draft_layers: int):
    """Speculative chunk: `rounds` rounds of (K = `depth` sequential DRAFT
    steps + ONE K+1-wide VERIFY forward); each round emits 1..K+1 tokens
    per slot. ``seeds`` None: a greedy-only engine (argmax, no logprobs).

    The draft is the target's own first `draft_layers` layers (the
    ``llama.draft_params`` view) plus an optional residual adapter head
    (``mlp.apply_draft_head``). It writes its k/v rows IN PLACE, into the
    target's cache, where JAX keeps them in a private copy: the draft
    writes rows pos..min(pos+K-1, max_len-1) of its layers, and the verify
    rewrites rows pos..min(pos+K, max_len-1) of every layer before any of
    its queries attends to them, so no draft row survives a round (and no
    copy of the draft's layers, ~104 MB a round at the 1B shape, is made).

    The verify computes the target's own token y_j at every position on
    the same (seed, position) lanes as the plain chunk (argmax at
    temperature 0), accepts draft tokens up to the first mismatch with y
    and emits y at the mismatch, so the emitted sequence is the plain
    decode's. Rollback is free: pos advances by the accepted count only;
    rejected rows sit past the mask and are overwritten before it reaches
    them.

    Returns (toks [B, rounds, K+1], lps [B, rounds, K+1] f32 or None,
    counts [B, rounds] — tokens emitted per round, 0 for inactive slots —
    cache, [B] last token)."""
    max_len = cache["k"].shape[2]
    weights = _weights(params, cfg)
    embed, layers, w_out = weights
    b = tok.shape[0]
    t_wide = depth + 1
    lanes = None if seeds is None else (seeds, temps, top_ps)
    wide_lanes = None if lanes is None else tuple(
        x.repeat_interleave(t_wide) for x in lanes)
    rows = torch.arange(b, device=tok.device)
    k_all, v_all, pos = cache["k"], cache["v"], cache["pos"]
    t = tok
    out_y, out_lp, out_m = [], [], []
    for _ in range(rounds):
        # -- draft: K sequential 1-wide steps over the trunk layers --
        d, dpos, drafts = t, pos, []
        for _ in range(depth):
            logits = _step_logits(cfg, params, weights, d, k_all, v_all, dpos,
                                  n_layers=draft_layers, head=draft_head)
            # the proposal for dpos+1 rides lane dpos: the lane the verify
            # samples that position's token on, so under sampling draft
            # and target draw with shared Gumbel noise
            d, _ = _pick(logits, lanes, dpos)
            dpos = torch.clamp(dpos + 1, max=max_len - 1)
            drafts.append(d)
        drafts = torch.stack(drafts, dim=1)  # [B, K]

        # -- verify: ONE wide forward over the K+1 positions --
        xs = torch.cat([t[:, None], drafts], dim=1)  # [B, T]
        idx = _verify_index(pos, t_wide, max_len)
        qpos = pos[:, None] + torch.arange(t_wide, dtype=pos.dtype,
                                           device=pos.device)
        sin, cos = llama.rotary_embedding(qpos, cfg.head_dim, cfg.rope_theta)
        h = embed[xs.long()]  # [B, T, D]
        for i, p in enumerate(layers):
            h = _layer_verify_ragged(cfg, h, p, sin, cos, k_all[i], v_all[i],
                                     idx)
        h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
        logits = (h @ w_out).float()  # [B, T, V]
        y, lp = _pick(logits.reshape(b * t_wide, -1), wide_lanes,
                      qpos.reshape(-1))
        y = y.reshape(b, t_wide)

        # -- accept until first mismatch; rollback = pos truncation --
        match = (drafts == y[:, :depth]).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1) + 1  # [B] in 1..K+1
        m = torch.where(active, m, torch.zeros_like(m))
        t = torch.where(active, y[rows, torch.clamp(m - 1, min=0)], t)
        pos = torch.clamp(pos + m.to(pos.dtype), max=max_len - 1)
        out_y.append(y)
        out_lp.append(None if lp is None else lp.reshape(b, t_wide))
        out_m.append(m)
    return (torch.stack(out_y, dim=1),
            None if lanes is None else torch.stack(out_lp, dim=1),
            torch.stack(out_m, dim=1), {"k": k_all, "v": v_all, "pos": pos}, t)


# --------------------------------------------------------------------------
# Prefill and adoption
# --------------------------------------------------------------------------

def _greedy_lanes(f: int):
    return (np.zeros((f,), np.int64), np.zeros((f,), np.float32),
            np.ones((f,), np.float32))


def _prefill_rows(params, prompts, true_lens, cfg: LlamaConfig, slot_len: int):
    """Run [F, P] right-padded prompts through a fresh slot_len cache:
    (the logits at each row's last true position [F, V] f32, the cache)."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts).to(dev)
    lens = np.asarray(true_lens, np.int64)
    f = prompts.shape[0]
    tmp = llama.init_cache(cfg, f, slot_len, device=dev)
    logits, tmp = llama.forward_with_cache(params, prompts, cfg, tmp)
    return logits[_to_device(np.arange(f), dev), _to_device(lens - 1, dev)], tmp


def _sample_first(last, true_lens, lanes):
    """First tokens and logprobs from the last prompt logits [F, V]: the
    (seed, true_len - 1) lane, as every prefill path samples it. A batch
    of greedy lanes (all temperatures 0, known on the host) takes the
    argmax and its log-softmax directly: the sampler's temperature-0
    result, bit for bit, without its ~400 launches."""
    dev = last.device
    seeds, temps, top_ps = (np.asarray(x) for x in lanes)
    if not temps.any():
        tok = last.argmax(dim=-1)
        lp = torch.log_softmax(last, dim=-1).gather(-1, tok[:, None])[:, 0]
        return tok.to(torch.int32), lp
    pos = np.asarray(true_lens, np.int64) - 1
    return _sample_from_logits(last, _to_device(seeds.astype(np.int64), dev),
                               _to_device(pos, dev),
                               _to_device(temps.astype(np.float32), dev),
                               _to_device(top_ps.astype(np.float32), dev))


@torch.no_grad()
def _prefill_batch_into_slots(params, prompts, true_lens, slots, cache,
                              cur_tok, cfg: LlamaConfig, seeds=None,
                              temps=None, top_ps=None):
    """Prefill a BATCH of streams ([F, P] right-padded tokens, one bucket
    P) into their slots of the ragged cache. ``slots`` and ``true_lens``
    are host arrays [F]; rows whose slot index lies outside the cache are
    dropped (filtered here: torch has no scatter mode='drop'). seeds /
    temps / top_ps [F] are the per-stream sampling lanes (None: greedy).

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
    lanes = _greedy_lanes(f) if seeds is None else (seeds, temps, top_ps)
    last, tmp = _prefill_rows(params, prompts, true_lens, cfg, slot_len)
    toks0, logp0 = _sample_first(last, true_lens, lanes)
    keep = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if len(keep):
        keep_d = _to_device(keep, dev)
        slot_d = _to_device(slots[keep], dev)
        cache["k"][:, slot_d] = tmp["k"][:, keep_d]
        cache["v"][:, slot_d] = tmp["v"][:, keep_d]
        cache["pos"][slot_d] = _to_device(true_lens[keep].astype(np.int32), dev)
        cur_tok[slot_d] = toks0[keep_d]
    return cache, cur_tok, toks0, logp0


@torch.no_grad()
def prefill_kv(params, prompts, true_lens, cfg: LlamaConfig, slot_len: int):
    """Prefill WITHOUT a slot, the dedicated prefill worker's op: [F, P]
    right-padded prompts through a fresh slot_len cache. Returns the raw
    KV rows and the first greedy tokens ((k, v) [L, F, S, Hkv, D], toks0
    [F] int32); a decode engine adopts the rows with
    ``RaggedDecoder.submit_prefilled``. The same math as an inline
    prefill, so the adopted stream continues as an inline one does."""
    last, tmp = _prefill_rows(params, prompts, true_lens, cfg, slot_len)
    return tmp["k"], tmp["v"], last.argmax(dim=-1).to(torch.int32)


@torch.no_grad()
def prefill_kv_sampled(params, prompts, true_lens, seeds, temps, top_ps,
                       cfg: LlamaConfig, slot_len: int):
    """:func:`prefill_kv` with the sampling lanes (host arrays [F]): the
    first token comes from the same (seed, true_len - 1) lane as an inline
    prefill and its behaviour logprob rides the payload. Returns ((k, v)
    [L, F, S, Hkv, D], toks0 [F], logp0 [F])."""
    last, tmp = _prefill_rows(params, prompts, true_lens, cfg, slot_len)
    toks0, logp0 = _sample_first(last, true_lens, (seeds, temps, top_ps))
    return tmp["k"], tmp["v"], toks0, logp0


@torch.no_grad()
def _adopt_kv_into_slot(k_rows, v_rows, true_len: int, tok0: int, slot: int,
                        cache, cur_tok, cfg: LlamaConfig):
    """Write externally prefilled KV rows ([L, S, Hkv, D], S == the slot
    length: FULL-SLOT OVERWRITE) into `slot` and seed its current token.
    The rows may be torch tensors or numpy arrays, of any float dtype."""
    dev = cache["k"].device
    for name, rows in (("k", k_rows), ("v", v_rows)):
        cache[name][:, slot] = _host_rows(rows).to(dev, cfg.compute_dtype)
    cache["pos"][slot] = int(true_len)
    cur_tok[slot] = int(tok0)
    return cache, cur_tok


@torch.no_grad()
def _prefill_suffix_into_slot(params, pref_k, pref_v, n_prefix: int, suffix,
                              suffix_len: int, lane, slot: int, cache,
                              cur_tok, cfg: LlamaConfig):
    """Prefix-cache warm path: the slot's rows become the cached prefix
    rows (pref_k/v [L, >=n_prefix, Hkv, D], host tensors) and zeros past
    them (FULL-SLOT OVERWRITE), then only the suffix ([SB] right-padded
    bucket) is prefilled at pos = n_prefix, in place in the slot. The
    first token rides the (seed, true_len - 1) lane, so warm and cold
    admission sample alike. ``lane``: (seed, temperature, top_p). Returns
    (cache, cur_tok, first token, its logprob) as 1-element tensors."""
    dev = cache["k"].device
    for name, rows in (("k", pref_k), ("v", pref_v)):
        slab = cache[name][:, slot]
        slab.zero_()
        slab[:, :n_prefix] = rows[:, :n_prefix].to(dev, slab.dtype)
    view = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1],
            "pos": n_prefix}
    suffix = _to_device(np.asarray(suffix, np.int32)[None], dev)
    logits, _ = llama.forward_with_cache(params, suffix, cfg, view)
    true_len = n_prefix + suffix_len
    tok0, logp0 = _sample_first(logits[:, suffix_len - 1], [true_len],
                                tuple(np.asarray([x]) for x in lane))
    cache["pos"][slot] = true_len
    cur_tok[slot] = tok0[0]
    return cache, cur_tok, tok0, logp0


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

@dataclass
class _Stream:
    sid: int
    prompt: np.ndarray
    max_new: int
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)  # parallel to tokens
    token_times: list = field(default_factory=list)  # perf_counter stamps
    submitted: float = 0.0  # perf_counter stamp of the submit
    done: bool = False
    taken: int = 0  # tokens already handed out via take_tokens()
    prefilled: dict | None = None  # external KV payload (k/v/first_token)
    # sampling lane (temperature 0 = greedy, the default serving mode)
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    # weight version the stream decodes under: None until admission
    # stamps the ENGINE's version (which may lag a pool publish)
    version: int | None = None
    tenant: str = "-"  # for per-tenant SLO attribution
    pc_have: int = 0  # prefix-cache rows matched at admission


class RaggedDecoder:
    """The engine: fixed slot batch + chunked continuous batching.

    submit() enqueues; pump() admits queued streams into free slots
    (prefill) and advances one chunk; finished streams free their slots
    at once. Thread-unsafe by design: ONE pump owner drives it.
    ``params`` (and ``spec_draft_head``) must live on ``device`` (default
    ``cuda``). ``name`` tags the engine's metrics, spans and chaos sites;
    ``chunk_delay_s`` sleeps that long in every pump before its fetch (a
    stand-in for device latency when the serving tier is benchmarked on
    a host without a card); ``hooks`` carries the runtime calls."""

    MAX_SPEC_DEPTH = 8
    RATE_WINDOW_S = 5.0
    METRICS_PERIOD_S = 1.0

    def __init__(self, params, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: int = 512, chunk_tokens: int = 32,
                 prompt_buckets: tuple = (32, 64, 128, 256),
                 prefix_cache=None, name: str = "default",
                 chunk_delay_s: float = 0.0, weights_version: int = 0,
                 spec_depth: int = 0,
                 spec_draft_layers: int = 0, spec_draft_head=None,
                 device=None, hooks: _hooks.Hooks | None = None):
        self.device = resolve_device(device)
        self._check_params(params)
        self.params = params
        self.name = name
        self.chunk_delay_s = chunk_delay_s
        self.hooks = hooks or _hooks.INERT
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk_tokens
        self.buckets = tuple(sorted(prompt_buckets))
        self.cache = init_ragged_cache(cfg, slots, max_len, self.device)
        self.cur_tok = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        # per-slot sampling lanes, rewritten at admission; frozen slots'
        # values are dead (their sampled token is overwritten anyway)
        self._slot_seed = np.zeros((slots,), np.int64)
        self._slot_temp = np.zeros((slots,), np.float32)
        self._slot_topp = np.ones((slots,), np.float32)
        # sticky: flips at the first sampled submit and stays. A
        # greedy-only engine keeps the argmax chunk (no per-token sort,
        # noise or log-softmax; chunk-token logprobs reported as 0.0)
        self._sampling_seen = False
        self.weights_version = int(weights_version)
        self.pumps = 0  # engine steps: staleness windows count these
        self.slot_stream: list[_Stream | None] = [None] * slots
        self.queue: collections.deque[_Stream] = collections.deque()
        self._next_sid = 0
        self.finished: dict[int, _Stream] = {}
        # (stream, device tok0, device logp0) fetched with the next chunk
        self._pending_first: list = []
        self._by_sid: dict[int, _Stream] = {}
        self.prefix_cache = prefix_cache  # models.kv_prefix_cache or None
        # speculative decoding: depth K drafts per verify round, 0 = off
        self.spec_depth = max(0, int(spec_depth))
        ld = int(spec_draft_layers) or max(1, cfg.n_layers // 2)
        self.spec_draft_layers = min(max(ld, 1), cfg.n_layers)
        self.spec_draft_head = spec_draft_head
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_pumps = 0
        # accept_hist[m]: verify rounds (of active slots) that accepted
        # exactly m draft tokens, 0..depth
        self._spec_hist: collections.Counter = collections.Counter()
        self._total_tokens = 0
        # (stamp, n_tokens) per pump for the tokens/s signal
        self._rate_window: collections.deque = collections.deque()
        self._metrics_t = 0.0

    def _check_params(self, params) -> None:
        got = params["embed"].device
        if torch.device(got.type, got.index or 0) != torch.device(
                self.device.type, self.device.index or 0):
            raise ValueError(f"params live on {got}, engine device is "
                             f"{self.device}")

    # -- submission boundary --

    def _new_stream(self, prompt, max_new, temperature, top_p, seed,
                    tenant, prefilled=None) -> int:
        """Checks shared by both submits, then enqueue."""
        room = self.max_len - len(prompt) - 1
        if room < 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no decode room "
                f"in a max_len={self.max_len} cache")
        if not 0.0 < float(top_p) <= 1.0:
            # an out-of-range top_p would filter EVERY logit to -inf (NaN
            # logprobs, arbitrary tokens) instead of failing loudly
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if float(temperature) > 0.0:
            self._sampling_seen = True
        s = _Stream(self._next_sid, prompt, min(max_new, room),
                    submitted=time.perf_counter(),
                    prefilled=prefilled, temperature=float(temperature),
                    top_p=float(top_p), seed=int(seed) & 0xFFFFFFFF,
                    tenant=str(tenant))
        self._next_sid += 1
        self.queue.append(s)
        self._by_sid[s.sid] = s
        return s.sid

    def submit(self, prompt_tokens, max_new: int, *,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0, tenant: str = "-") -> int:
        """Validates HERE (caller's thread) so a bad request raises at the
        submitter, never inside the pump loop. ``temperature`` 0 is greedy
        decode; > 0 samples on the stream's (seed, position) RNG lane with
        nucleus (top-p) filtering."""
        prompt = np.asarray(prompt_tokens, np.int32)
        self._bucket(len(prompt))  # raises if no bucket fits
        return self._new_stream(prompt, max_new, temperature, top_p, seed,
                                tenant)

    def submit_prefilled(self, prompt_tokens, max_new: int, kv: dict, *,
                         temperature: float = 0.0, top_p: float = 1.0,
                         seed: int = 0, tenant: str = "-") -> int:
        """Enqueue a stream whose prefill already happened elsewhere (a
        dedicated prefill worker). `kv`: {"k"/"v": [n_layers, S,
        n_kv_heads, head_dim] torch tensors or numpy arrays with S == this
        engine's max_len, "first_token": int, "true_len": int, and
        optionally "first_logprob": float}. Admission is a pure slot
        write: no prefill."""
        prompt = np.asarray(prompt_tokens, np.int32)
        k, v = _host_rows(kv["k"]), _host_rows(kv["v"])
        if k.shape[1] != self.max_len:
            raise ValueError(
                f"prefilled KV has {k.shape[1]} rows; this engine's "
                f"slots hold {self.max_len} (prefill and decode pools "
                f"must agree on max_len)")
        if int(kv["true_len"]) != len(prompt):
            raise ValueError("prefilled true_len != prompt length")
        payload = {"k": k, "v": v,
                   "first_token": int(kv["first_token"]),
                   "first_logprob": float(kv.get("first_logprob", 0.0))}
        return self._new_stream(prompt, max_new, temperature, top_p, seed,
                                tenant, prefilled=payload)

    def pop_finished(self, sid: int) -> _Stream | None:
        self._by_sid.pop(sid, None)
        return self.finished.pop(sid, None)

    def stream_version(self, sid: int) -> int | None:
        """The weight version `sid`'s tokens are generated under (None
        until admission)."""
        s = self._by_sid.get(sid)
        return None if s is None else s.version

    def purge(self, sid: int) -> None:
        """Drop a finished/abandoned stream's bookkeeping."""
        self._by_sid.pop(sid, None)
        self.finished.pop(sid, None)

    def take_tokens(self, sid: int, *, with_logprobs: bool = False):
        """Streaming read: tokens appended since the last take plus a done
        flag (and the parallel behaviour logprobs with
        ``with_logprobs=True``). The pump appends logprobs BEFORE tokens,
        so the parallel slice never runs ahead of them. A fully drained
        finished stream is purged on the way out."""
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

    def _set_lane(self, slot: int, s: _Stream) -> None:
        self._slot_seed[slot] = s.seed
        self._slot_temp[slot] = s.temperature
        self._slot_topp[slot] = s.top_p

    def _lanes(self):
        """The slots' sampling lanes (seeds, temps, top_ps) on the device,
        or three Nones for a greedy-only engine."""
        if not self._sampling_seen:
            return None, None, None
        return tuple(_to_device(x, self.device) for x in
                     (self._slot_seed, self._slot_temp, self._slot_topp))

    def _admit(self):
        free = [i for i, s in enumerate(self.slot_stream) if s is None]
        grabbed: list[tuple[int, _Stream]] = []
        while free and self.queue:
            grabbed.append((free.pop(), self.queue.popleft()))
        cold: list[tuple[int, _Stream]] = []
        t_now = time.perf_counter()
        for slot, s in grabbed:
            s.version = self.weights_version
            self._set_lane(slot, s)
            if s.prefilled is not None:
                # disaggregated: the KV rows came from a prefill worker;
                # admission is one slot write and the first token is known
                p = s.prefilled
                self.cache, self.cur_tok = _adopt_kv_into_slot(
                    p["k"], p["v"], len(s.prompt), p["first_token"], slot,
                    self.cache, self.cur_tok, self.cfg)
                s.logprobs.append(p["first_logprob"])
                s.tokens.append(p["first_token"])
                s.token_times.append(t_now)
                s.prefilled = None  # free the host slab
                self.slot_stream[slot] = s
            elif self.prefix_cache is not None and self._admit_warm(slot, s):
                pass  # adopted a cached prefix + suffix prefill
            else:
                cold.append((slot, s))
        by_bucket: dict[int, list] = {}
        for slot, s in cold:
            by_bucket.setdefault(self._bucket(len(s.prompt)), []).append(
                (slot, s))
        f = self.slots  # static prefill width: the same products per wave
        for pb, entries in by_bucket.items():
            prompts = np.zeros((f, pb), np.int32)
            lens = np.ones((f,), np.int32)
            slots_arr = np.full((f,), f + 1024, np.int32)  # OOB: dropped
            seeds, temps, topps = _greedy_lanes(f)
            for i, (slot, s) in enumerate(entries):
                prompts[i, :len(s.prompt)] = s.prompt  # right-pad
                lens[i] = len(s.prompt)
                slots_arr[i] = slot
                seeds[i], temps[i], topps[i] = s.seed, s.temperature, s.top_p
            (self.cache, self.cur_tok, toks0,
             logp0) = _prefill_batch_into_slots(
                self.params, _to_device(prompts, self.device), lens,
                slots_arr, self.cache, self.cur_tok, self.cfg, seeds, temps,
                topps)
            # no host sync here: first tokens ride the next chunk's fetch
            for i, (slot, s) in enumerate(entries):
                self._pending_first.append((s, toks0[i], logp0[i]))
                self.slot_stream[slot] = s
            if self.prefix_cache is not None:
                self._insert_prefixes(entries)

    def _admit_warm(self, slot: int, s: _Stream) -> bool:
        """Try the prefix-cache warm path for one stream: adopt the longest
        cached block-aligned prefix and prefill only the suffix. Returns
        False (cold path) on a miss, or when no suffix bucket fits the
        remaining cache rows. The matched depth is remembered on the
        stream so the post-prefill insert fetches only rows the cache
        lacks."""
        pc = self.prefix_cache
        n_pref, entry = pc.match(s.prompt)
        s.pc_have = n_pref
        if entry is None:
            pc.record_outcome(False)
            return False
        suffix = s.prompt[n_pref:]
        try:
            sb = self._bucket(len(suffix))
        except ValueError:
            pc.record_outcome(False)  # matched but unusable: cold path
            return False
        if n_pref + sb > self.max_len:
            # the static suffix window would run past the cache
            pc.record_outcome(False)
            return False
        suf = np.zeros((sb,), np.int32)
        suf[:len(suffix)] = suffix
        self.cache, self.cur_tok, tok0, logp0 = _prefill_suffix_into_slot(
            self.params, entry["k"], entry["v"], n_pref, suf, len(suffix),
            (s.seed, s.temperature, s.top_p), slot, self.cache, self.cur_tok,
            self.cfg)
        self._pending_first.append((s, tok0[0], logp0[0]))
        self.slot_stream[slot] = s
        pc.record_outcome(True)  # cached rows actually served
        return True

    def _insert_prefixes(self, entries) -> None:
        """After a cold batched prefill, capture each stream's
        block-aligned prefix rows into the prefix cache: one device->host
        copy per stream that has blocks the cache lacks."""
        pc = self.prefix_cache
        for slot, s in entries:
            n_ins = ((len(s.prompt) - 1) // pc.block) * pc.block
            if n_ins < pc.block or s.pc_have >= n_ins:
                continue
            pc.insert(s.prompt[:n_ins], self.cache["k"][:, slot, :n_ins].cpu(),
                      self.cache["v"][:, slot, :n_ins].cpu())

    def _take_firsts(self):
        """The pending first tokens and logprobs as two device tensors (to
        ride the pump's one fetch) and their streams."""
        firsts, self._pending_first = self._pending_first, []
        if not firsts:
            empty = torch.zeros((0,), dtype=torch.int32, device=self.device)
            return [], empty, empty.float()
        return ([s for s, _, _ in firsts],
                torch.stack([t for _, t, _ in firsts]).to(torch.int32),
                torch.stack([lp for _, _, lp in firsts]).to(torch.float32))

    def _deliver_firsts(self, streams, toks, lps, t_now: float) -> int:
        for s, t0, lp0 in zip(streams, toks, lps):
            # logprob first, token second: take_tokens slices both lists
            # by len(tokens), so the parallel list must never lag it
            s.logprobs.append(float(lp0))
            s.tokens.append(int(t0))
            s.token_times.append(t_now)
        return len(streams)

    def _fetch_pump(self, parts: list, lps) -> list:
        """The pump's ONE device->host transfer: `parts` and, unless the
        engine is greedy-only (`lps` None: its logprobs are the host's
        0.0 placeholders), the chunk's logprobs, last. The emulated
        dispatch delay, if any, is slept first."""
        if self.chunk_delay_s:
            time.sleep(self.chunk_delay_s)
        if lps is None:
            return _fetch(parts) + [None]
        return _fetch(parts + [lps])

    def _deliver(self, slot: int, s: _Stream, toks, lps, pos,
                 t_now: float) -> int:
        """Append a slot's new tokens (up to its max_new), stamped
        `t_now`, and free the slot when the stream is done. Returns the
        tokens delivered. `lps` None (a greedy-only engine) appends 0.0
        logprobs."""
        take = max(0, min(len(toks), s.max_new - len(s.tokens)))
        s.logprobs.extend([0.0] * take if lps is None
                          else (float(x) for x in lps[:take]))
        s.tokens.extend(int(x) for x in toks[:take])
        s.token_times.extend([t_now] * take)
        # per-token TBT: the stream's gap since its last stamp amortised
        # over the chunk's tokens (they reach the client together)
        if take > 0 and len(s.token_times) > take:
            prev = s.token_times[-take - 1]
            if t_now > prev:
                self._tbt_obs((t_now - prev) / take, s.tenant)
        if len(s.tokens) >= s.max_new or int(pos) >= self.max_len - 1:
            s.done = True
            self.finished[s.sid] = s
            self.slot_stream[slot] = None  # slot freed THIS chunk
        return take

    @torch.no_grad()
    def pump(self) -> int:
        """Admit + advance one chunk; returns the number of active slots.

        Exactly ONE device->host transfer per chunk: the chunk's tokens
        (and logprobs), per-slot pos and pending first tokens/logprobs
        travel together."""
        self._admit()
        self.pumps += 1
        active_mask = np.array([st is not None for st in self.slot_stream])
        if not active_mask.any():
            return 0
        depth = self._spec_depth_now()
        # chaos site: "drop" runs this chunk on the plain path, which
        # emits the same tokens (fewer per pump)
        if depth > 0 and self.hooks.fire("serve.spec_verify",
                                         engine=self.name) == "drop":
            depth = 0
        if depth > 0:
            return self._pump_spec(active_mask, depth)
        toks, lps, self.cache, self.cur_tok = decode_chunk_sampled(
            self.params, self.cache, self.cur_tok,
            _to_device(active_mask, self.device), *self._lanes(), self.cfg,
            self.chunk)
        streams, ftoks, flps = self._take_firsts()
        toks_np, pos_np, ftoks_np, flps_np, lps_np = self._fetch_pump(
            [toks, self.cache["pos"], ftoks, flps], lps)
        t_now = time.perf_counter()
        delivered = self._deliver_firsts(streams, ftoks_np, flps_np, t_now)
        for slot, s in enumerate(self.slot_stream):
            if s is not None:
                delivered += self._deliver(
                    slot, s, toks_np[slot],
                    None if lps_np is None else lps_np[slot], pos_np[slot],
                    t_now)
        self._account(t_now, delivered)
        return int(active_mask.sum())

    def _spec_depth_now(self) -> int:
        """Draft depth for this pump, read from the live config at every
        pump: ``serve_spec_enabled`` gates speculation and
        ``serve_spec_depth`` > 0 overrides the constructor's depth.
        Clamped to MAX_SPEC_DEPTH; 0 when speculation is off."""
        try:
            if not self.hooks.config_get("serve_spec_enabled"):
                return 0
            override = int(self.hooks.config_get("serve_spec_depth"))
        except Exception:  # noqa: BLE001 — config never breaks decode
            override = 0
        depth = override if override > 0 else self.spec_depth
        return max(0, min(depth, self.MAX_SPEC_DEPTH))

    def _pump_spec(self, active_mask, depth: int) -> int:
        """Speculative pump: `chunk` draft/verify rounds, emitting
        1..depth+1 tokens per slot per round. Same single device->host
        transfer as the plain pump; per-slot sequences are assembled on
        the host from the per-round accept counts."""
        t0 = time.perf_counter()
        toks, lps, counts, self.cache, self.cur_tok = decode_chunk_spec(
            self.params, self.spec_draft_head, self.cache, self.cur_tok,
            _to_device(active_mask, self.device), *self._lanes(), self.cfg,
            self.chunk, depth, self.spec_draft_layers)
        streams, ftoks, flps = self._take_firsts()
        toks_np, counts_np, pos_np, ftoks_np, flps_np, lps_np = (
            self._fetch_pump([toks, counts, self.cache["pos"], ftoks, flps],
                             lps))
        t_now = time.perf_counter()
        delivered = self._deliver_firsts(streams, ftoks_np, flps_np, t_now)
        proposed = accepted = 0
        for slot, s in enumerate(self.slot_stream):
            if s is None:
                continue
            seq_t: list = []
            seq_lp: list = []
            for r in range(counts_np.shape[1]):
                m = int(counts_np[slot, r])
                if m <= 0:
                    continue
                seq_t.extend(toks_np[slot, r, :m])
                seq_lp.extend([0.0] * m if lps_np is None
                              else lps_np[slot, r, :m])
                proposed += depth
                accepted += m - 1
                self._spec_hist[m - 1] += 1
            delivered += self._deliver(slot, s, seq_t, seq_lp, pos_np[slot],
                                       t_now)
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._spec_pumps += 1
        if proposed:
            try:
                m = self.hooks.metrics()
                tags = {"engine": self.name}
                m["spec_proposed"].inc(proposed, tags)
                m["spec_accepted"].inc(accepted, tags)
            except Exception:  # noqa: BLE001 — telemetry never breaks decode
                pass
        try:
            off = time.monotonic() - time.perf_counter()
            self.hooks.record(
                "serve", "serve.spec_verify", t0 + off, t_now + off,
                attrs={"engine": self.name, "depth": depth,
                       "rounds": self.chunk, "proposed": proposed,
                       "accepted": accepted},
                flush=False)  # per-pump hot path: ring-only
        except Exception:  # noqa: BLE001
            pass
        self._account(t_now, delivered)
        return int(active_mask.sum())

    def set_params(self, params, version: int) -> None:
        """Adopt new weights at a chunk boundary (pump owner's thread only).
        The prefix cache is dropped wholesale: its rows were computed under
        the old weights. In-flight streams keep their already-computed KV
        (their recorded per-token logprobs stay exact regardless)."""
        self._check_params(params)
        self.params = params
        self.weights_version = int(version)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()

    def _tbt_obs(self, v: float, tenant: str = "-") -> None:
        try:
            self.hooks.metrics()["tbt"].observe(
                v, {"engine": self.name, "tenant": tenant})
        except Exception:  # noqa: BLE001 — telemetry never breaks decode
            pass

    def _account(self, t_now: float, delivered: int) -> None:
        self._total_tokens += delivered
        w = self._rate_window
        w.append((t_now, delivered))
        while w and t_now - w[0][0] > self.RATE_WINDOW_S:
            w.popleft()
        if t_now - self._metrics_t >= self.METRICS_PERIOD_S:
            self._metrics_t = t_now
            self._export_metrics(self.stats())

    def tokens_per_sec(self) -> float:
        w = self._rate_window
        if len(w) < 2:
            return 0.0
        span = w[-1][0] - w[0][0]
        return sum(n for _, n in w) / span if span > 0 else 0.0

    def stats(self) -> dict:
        """Occupancy, queue depth, recent tokens/s, the weight version and
        pump count; the prefix cache's and the speculation's counters when
        they are on."""
        occupancy = [st.sid if st is not None else None
                     for st in self.slot_stream]
        active = sum(1 for st in self.slot_stream if st is not None)
        out = {
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
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self.spec_depth or self._spec_pumps:
            prop, acc = self._spec_proposed, self._spec_accepted
            out["spec"] = {
                "depth": self.spec_depth,
                "draft_layers": self.spec_draft_layers,
                "pumps": self._spec_pumps,
                "proposed": prop,
                "accepted": acc,
                "acceptance_rate": round(acc / prop, 4) if prop else 0.0,
                # accepted-length histogram: length -> verify rounds
                "accept_hist": {str(k): v
                                for k, v in sorted(self._spec_hist.items())},
            }
        return out

    def _export_metrics(self, st: dict) -> None:
        try:
            m = self.hooks.metrics()
            tags = {"engine": self.name}
            m["active"].set(st["active"], tags)
            m["queued"].set(st["queued"], tags)
            m["tps"].set(st["tokens_per_sec"], tags)
            pc = st.get("prefix_cache")
            if pc is not None:
                m["hit_rate"].set(pc["hit_rate"], tags)
        except Exception:  # noqa: BLE001 — telemetry never breaks decode
            pass

    @torch.no_grad()
    def drain(self, deadline_s: float = 600.0) -> None:
        t0 = time.monotonic()
        while self.queue or any(s is not None for s in self.slot_stream):
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError("decode drain exceeded deadline")
            self.pump()
