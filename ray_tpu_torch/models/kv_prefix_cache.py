"""Block-granular prefix/KV cache for repeated prompt prefixes, in PyTorch.

The port's own copy of ray_tpu/models/kv_prefix_cache.py. Serving
traffic is dominated by requests that share a long fixed head (system
prompt, few-shot preamble) followed by a short unique tail; causal
attention makes a token's k/v depend only on the tokens at or before it,
so the KV rows of a shared prefix are the same for every request that
starts with it.

Rows are keyed by a CHAIN HASH over token blocks: block i's key folds
block i-1's key with block i's int32 token bytes (blake2b, 16 bytes), so
a lookup walks the prompt block by block and the deepest hit is the
longest cached block-aligned prefix. The keys are byte-equal to the JAX
package's. Values are host-side row slabs ([n_layers, n_tokens,
n_kv_heads, head_dim] for k and v) captured from a completed prefill;
here they are torch CPU tensors, which hold bfloat16 (numpy does not).
Eviction is LRU bounded by a byte budget.

Adopting cached rows and prefilling only the suffix gives the same k/v
rows as a cold full prefill, up to the rounding of products whose shapes
differ (``decode_engine.RaggedDecoder._admit_warm``).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch


def _block_key(prev_key: bytes, block_tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev_key)
    h.update(np.ascontiguousarray(block_tokens, dtype=np.int32).tobytes())
    return h.digest()


def chain_keys(tokens: np.ndarray, block: int) -> list[bytes]:
    """Chain hash per complete block: keys[i] covers tokens[: (i+1)*block]."""
    keys: list[bytes] = []
    prev = b"kvpc"
    for start in range(0, (len(tokens) // block) * block, block):
        prev = _block_key(prev, tokens[start:start + block])
        keys.append(prev)
    return keys


class PrefixCache:
    """LRU KV-prefix store. Thread-safe (the decode pump inserts while
    handler threads may query stats).

    One entry per distinct block-aligned prefix length, so a long shared
    head costs one slab per block depth actually observed, and lookup
    returns the deepest cached depth."""

    def __init__(self, block: int = 32, max_bytes: int = 256 * 2**20):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = block
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: OrderedDict[bytes, dict] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    # -- lookup / insert --

    def match(self, tokens) -> tuple[int, dict | None]:
        """Longest cached block-aligned prefix of `tokens`, capped at
        len(tokens)-1 so at least the final prompt token always goes
        through suffix prefill (its logits give the first token). Counts
        no hit or miss: the caller records the OUTCOME (record_outcome)
        once it knows whether the match was served."""
        toks = np.asarray(tokens, np.int32)
        usable = len(toks) - 1
        best: dict | None = None
        with self._lock:
            for i, key in enumerate(chain_keys(toks, self.block)):
                n = (i + 1) * self.block
                if n > usable:
                    break
                e = self._entries.get(key)
                if e is None:
                    break  # chain broken: deeper keys can't exist either
                self._entries.move_to_end(key)
                best = e
        return (best["n"], best) if best is not None else (0, None)

    def record_outcome(self, hit: bool) -> None:
        """One admission's outcome: True when cached rows were adopted,
        False when the request prefilled cold (miss, or a match the
        engine could not use)."""
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def insert(self, tokens, k_rows, v_rows) -> int:
        """Cache every block-aligned prefix depth of `tokens` not already
        present. k_rows/v_rows: [n_layers, >=n, n_kv_heads, head_dim] host
        tensors covering at least the hashed prefix. Returns the number of
        NEW entries inserted."""
        toks = np.asarray(tokens, np.int32)
        new = 0
        with self._lock:
            for i, key in enumerate(chain_keys(toks, self.block)):
                n = (i + 1) * self.block
                if n > k_rows.shape[1]:
                    continue
                if key in self._entries:
                    self._entries.move_to_end(key)
                    continue
                k = k_rows[:, :n].clone(memory_format=torch.contiguous_format)
                v = v_rows[:, :n].clone(memory_format=torch.contiguous_format)
                nbytes = (k.numel() * k.element_size()
                          + v.numel() * v.element_size())
                self._entries[key] = {"n": n, "k": k, "v": v,
                                      "nbytes": nbytes}
                self._bytes += nbytes
                self.inserts += 1
                new += 1
            while self._bytes > self.max_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old["nbytes"]
                self.evictions += 1
        return new

    # -- introspection --

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
