"""The prefill half of the serving pool, in PyTorch.

Mirrors ``PrefillWorker`` of ray_tpu/serve/llm_pool.py: a dedicated
prefill member computes a prompt's KV rows and first token and returns
them as a payload that a decode server adopts
(``LLMServer.adopt_prefilled`` / ``submit_stream_prefilled``), so long
prompts never stall a decode pump's chunk cadence. The payload's KV rows
are host tensors (numpy has no bfloat16), so it can ride an object store
from the prefill worker to the adopting replica.

``LLMPool`` (the admission queue, replica scaling, failover, the weight
publish) comes in the next slice, against an injected replica interface
that a runtime hosts.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.decode_engine import prefill_kv_sampled
from ray_tpu_torch.serve import hooks as _hooks
from ray_tpu_torch.serve.llm import adopt_params, build_model


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
