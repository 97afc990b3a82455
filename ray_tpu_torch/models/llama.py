"""Llama-family decoder-only transformer (dense), in PyTorch.

Mirrors ray_tpu/models/llama.py: the same config fields and named sizes,
the same parameter tree (layer weights stacked along axis 0, so a JAX
tree converts key for key), the same GQA + RoPE + SwiGLU + RMSNorm
pre-norm block. Weights keep JAX's ``x @ W`` orientation ([d_in, d_out]).

Differences in idiom: parameters are a dict of tensors on an explicit
device. For serving, matmul weights and the embedding are held in the
compute dtype and norm weights in f32; for training (``master=True``)
every leaf is an f32 master, as JAX's are. Weights are cast per use
(``.to(cfg.compute_dtype)``, a no-op for weights already in it). The KV
cache is updated IN PLACE (JAX's functional ``dynamic_update_slice``
becomes a slice write) and the layer "scan" is a Python loop. Remat maps
JAX's checkpoint policies onto ``torch.utils.checkpoint`` with selective
checkpointing (``_remat_policy``). MoE, pipeline stages and sharding
constraints are not part of this module (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import _repeat_kv, attention
from ray_tpu_torch.ops.losses import softmax_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rotary, rotary_embedding
from ray_tpu_torch.utils.checkpoint_names import checkpoint_name, current_name

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_NORMS = ("attn_norm", "mlp_norm")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: str = "bfloat16"  # compute dtype of weights and activations
    remat: bool = True  # checkpoint each layer when gradients are taken
    # which activations a layer saves for the backward (_REMAT_POLICIES)
    remat_policy: str = "dots"
    use_flash: bool | None = None  # None/True: flash kernel; False: reference
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def num_params(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        per_layer = attn + 3 * d * f + 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + l * per_layer + d + head

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-size config (runs on CPU in seconds)."""
        base = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype="float32",
        )
        base.update(kw)
        return LlamaConfig(**base)


def llama2_size(name: str) -> LlamaConfig:
    """Named dense sizes: '125m', '350m', '1b', '7b'."""
    table = {
        "125m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, d_ff=2048),
        "350m": dict(d_model=1024, n_layers=24, n_heads=8, n_kv_heads=8, d_ff=2816),
        "1b": dict(d_model=2048, n_layers=22, n_heads=16, n_kv_heads=8, d_ff=5632),
        "7b": dict(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32, d_ff=11008),
    }
    return LlamaConfig(**table[name])


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _shapes(cfg: LlamaConfig) -> dict:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    hq, hkv, l = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layers = {
        "attn_norm": (l, d),
        "wq": (l, d, hq * hd), "wk": (l, d, hkv * hd), "wv": (l, d, hkv * hd),
        "wo": (l, hq * hd, d),
        "mlp_norm": (l, d),
        "w_gate": (l, d, f), "w_up": (l, d, f), "w_down": (l, f, d),
    }
    out = {"embed": (cfg.vocab_size, d), "layers": layers, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device=None, master: bool = False) -> dict:
    """Random params with JAX's init law: embed ~ N(0, 1), each dense
    weight ~ N(0, 1/fan_in), norms 1. Drawn in f32 from ``generator``
    (seed 0 on the target device when None). Matmul weights and the
    embedding are then cast to the compute dtype (norms stay f32), or,
    with ``master=True``, every leaf stays f32 (training masters)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cdt = torch.float32 if master else cfg.compute_dtype

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        if fan_in:
            x /= math.sqrt(fan_in)
        return x.to(dev, cdt)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    shapes = _shapes(cfg)
    layers = {}
    for name, shape in shapes["layers"].items():
        layers[name] = ones(shape) if name in _NORMS else normal(shape, shape[1])
    params = {
        "embed": normal(shapes["embed"], 0),
        "layers": layers,
        "final_norm": ones(shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = normal(shapes["lm_head"], cfg.d_model)
    return params


def from_jax_params(np_tree: dict, cfg: LlamaConfig, device=None,
                    master: bool = False) -> dict:
    """Convert ray_tpu's JAX param tree, given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), into this module's.

    Same keys and stacked [L, ...] shapes; weights keep the ``x @ W``
    orientation [d_in, d_out], so nothing is transposed. Matmul weights
    and the embedding go to the compute dtype, norms to f32; with
    ``master=True`` every leaf stays f32."""
    dev = resolve_device(device)
    shapes = _shapes(cfg)
    wdt = torch.float32 if master else cfg.compute_dtype

    def conv(a, shape, is_norm):
        a = np.array(a, np.float32)  # a writable copy the tensor can own
        if a.shape != tuple(shape):
            raise ValueError(f"param shape {a.shape} != expected {shape}")
        return torch.from_numpy(a).to(dev, torch.float32 if is_norm else wdt)

    out = {
        "embed": conv(np_tree["embed"], shapes["embed"], False),
        "layers": {k: conv(np_tree["layers"][k], s, k in _NORMS)
                   for k, s in shapes["layers"].items()},
        "final_norm": conv(np_tree["final_norm"], shapes["final_norm"], True),
    }
    if "lm_head" in shapes:
        out["lm_head"] = conv(np_tree["lm_head"], shapes["lm_head"], False)
    return out


def _unbind_layers(params: dict) -> list:
    """Per-layer views of the stacked [L, ...] weights. One unbind per
    leaf, so a backward stacks each leaf's gradient once instead of
    summing L full-size scatters."""
    per_leaf = {k: v.unbind(0) for k, v in params["layers"].items()}
    n_layers = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n_layers)]


def _w_out(params: dict, cfg: LlamaConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return w.to(cfg.compute_dtype)


def _embed(params: dict, cfg: LlamaConfig, tokens) -> torch.Tensor:
    """Embedding lookup from the table cast to the compute dtype (as JAX
    casts it before its gather)."""
    return params["embed"].to(cfg.compute_dtype)[tokens.long()]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _qkv(cfg: LlamaConfig, p, h, sin, cos):
    """Pre-norm QKV projection + rotary, shared by every layer variant."""
    b, t, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    x = rms_norm(h, p["attn_norm"], cfg.rms_eps)
    q = (x @ p["wq"].to(cdt)).reshape(b, t, hq, hd)
    k = (x @ p["wk"].to(cdt)).reshape(b, t, hkv, hd)
    v = (x @ p["wv"].to(cdt)).reshape(b, t, hkv, hd)
    return apply_rotary(q, sin, cos), apply_rotary(k, sin, cos), v


def _attn_out_and_mlp(cfg: LlamaConfig, p, h, o):
    """wo projection + residual + dense SwiGLU MLP + residual. gate and
    up carry the reference's checkpoint names (mlp_gate, mlp_up)."""
    b, t, _ = h.shape
    cdt = cfg.compute_dtype
    h = h + o.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"].to(cdt)
    x = rms_norm(h, p["mlp_norm"], cfg.rms_eps)
    w_gate, w_up = p["w_gate"].to(cdt), p["w_up"].to(cdt)
    with checkpoint_name("mlp_gate"):
        gate = x @ w_gate
    with checkpoint_name("mlp_up"):
        up = x @ w_up
    y = (F.silu(gate) * up) @ p["w_down"].to(cdt)
    return h + y


def _layer(cfg: LlamaConfig, h, p, sin, cos):
    """One pre-norm transformer block. h: [B, T, D] in compute dtype."""
    q, k, v = _qkv(cfg, p, h, sin, cos)
    o = attention(q, k, v, causal=True, use_flash=cfg.use_flash)
    return _attn_out_and_mlp(cfg, p, h, o)


# JAX's remat policies (ray_tpu/models/llama.py:382-434) as (save the
# weight matmuls' outputs, checkpoint names to save). "flash" names the
# flash op, whose two outputs are the reference's flash_out and flash_lse.
_QKV = ("qkv_q", "qkv_k", "qkv_v")
_REMAT_POLICIES = {
    "dots": (True, ()),
    "dots_flash": (True, ("flash",)),
    "dots_flash_qkv": (True, ("flash",) + _QKV),
    "dots_flash_qkv_mlp": (True, ("flash",) + _QKV + ("mlp_gate", "mlp_up")),
    "flash_qkv": (False, ("flash",) + _QKV),
    "nothing": None,
}


def _save_policy(save_dots: bool, names: tuple, ctx, func, *args, **kwargs):
    """Save an op's outputs if it runs under a listed checkpoint name or,
    with ``save_dots``, if it is a weight matmul: ``x @ W`` dispatches as
    ``aten.mm`` (jax's dots_with_no_batch_dims; batched attention
    products are ``bmm`` and are recomputed)."""
    if current_name() in names or (save_dots and func is torch.ops.aten.mm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer_fn(cfg: LlamaConfig):
    """The layer function, wrapped in the config's activation checkpoint."""
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; expected "
            "'dots', 'dots_flash', 'dots_flash_qkv', "
            "'dots_flash_qkv_mlp', 'flash_qkv', or 'nothing'"
        )
    spec = _REMAT_POLICIES[cfg.remat_policy]
    kwargs = {}
    if spec is not None:  # "nothing": only the layer input survives
        policy = functools.partial(_save_policy, *spec)
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def run(h, p, sin, cos):
        return checkpoint(_layer, cfg, h, p, sin, cos, use_reentrant=False,
                          **kwargs)
    return run


def forward(params, tokens, cfg: LlamaConfig, *, positions=None):
    """tokens [B, T] int -> logits [B, T, V] in cfg.compute_dtype.

    Runs on the device that holds ``params``; attention goes through
    ``ops.attention`` (the CUDA flash kernels for CUDA tensors). When
    gradients are being recorded and ``cfg.remat`` is set, each layer runs
    under activation checkpointing with ``cfg.remat_policy``; remat
    changes memory and time, never values."""
    b, t = tokens.shape
    dev = params["embed"].device
    tokens = tokens.to(dev)
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    sin, cos = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    layer_fn = functools.partial(_layer, cfg)
    if cfg.remat and torch.is_grad_enabled():
        layer_fn = _remat_layer_fn(cfg)
    h = _embed(params, cfg, tokens)
    for p in _unbind_layers(params):
        h = layer_fn(h, p, sin, cos)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return h @ _w_out(params, cfg)


def loss_fn(params, batch, cfg: LlamaConfig):
    """batch: {'tokens': [B, T+1]} or {'inputs', 'targets'[, 'mask']}
    -> (loss, metrics)."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        toks = batch["tokens"]
        inputs, targets = toks[:, :-1], toks[:, 1:]
        mask = None
    logits = forward(params, inputs, cfg)
    targets = targets.to(logits.device)
    if mask is not None:
        mask = mask.to(logits.device)
    loss, n = softmax_cross_entropy(logits, targets, mask=mask)
    return loss, {"loss": loss, "tokens": n}


# --------------------------------------------------------------------------
# KV-cache inference (prefill + incremental decode)
# --------------------------------------------------------------------------
#
# A static-shape cache [L, B, max_len, Hkv, D] whose rows are written IN
# PLACE at the scalar position `pos` (a Python int: the number of filled
# rows), where the JAX version returns a new cache from
# dynamic_update_slice.

def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed KV cache on ``device``; pos = number of valid positions."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "pos": 0,
    }


def _masked_cache_attention(cfg: LlamaConfig, q, ck, cv, live):
    """Attention of q [B, T, Hq, D] over the whole static cache ck/cv
    [B, S, Hkv, D]; live [B or 1, T, S] bool marks visible slots. f32
    logits and softmax, probabilities cast to the compute dtype, f32
    accumulation of P.V (the JAX einsums' preferred_element_type)."""
    cdt = cfg.compute_dtype
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kk = _repeat_kv(ck, n_rep)
    vv = _repeat_kv(cv, n_rep)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kk.float()) \
        * (cfg.head_dim ** -0.5)
    logits = logits.masked_fill(~live[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(cdt)
    return torch.einsum("bhts,bshd->bthd", probs.float(), vv.float()).to(cdt)


def _layer_with_cache(cfg: LlamaConfig, h, p, sin, cos, ck, cv, pos: int):
    """_layer variant that writes this block's k/v at rows pos..pos+T-1 of
    ck/cv ([B, S, Hkv, D], in place) and attends the cache prefix: query i
    (global position pos+i) sees slots <= pos+i."""
    t = h.shape[1]
    s = ck.shape[1]
    q, k, v = _qkv(cfg, p, h, sin, cos)
    ck[:, pos:pos + t] = k
    cv[:, pos:pos + t] = v
    q_pos = pos + torch.arange(t, device=h.device)[:, None]
    k_pos = torch.arange(s, device=h.device)[None, :]
    o = _masked_cache_attention(cfg, q, ck, cv, (k_pos <= q_pos)[None])
    return _attn_out_and_mlp(cfg, p, h, o)


@torch.no_grad()
def forward_with_cache(params, tokens, cfg: LlamaConfig, cache: dict):
    """Run tokens [B, T] starting at cache['pos']; returns (logits [B,T,V]
    f32, cache). The cache's k/v tensors are updated in place; the
    returned dict shares them and carries pos + T. Covers both prefill
    (T = prompt length) and decode (T = 1). Runs without autograd, as
    inference: params that require grad build no graph."""
    b, t = tokens.shape
    pos = int(cache["pos"])
    if pos + t > cache["k"].shape[2]:
        raise ValueError(f"{t} tokens at pos {pos} overflow a cache of "
                         f"{cache['k'].shape[2]} rows")
    dev = params["embed"].device
    tokens = tokens.to(dev)
    positions = pos + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    sin, cos = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    h = _embed(params, cfg, tokens)
    for i, p in enumerate(_unbind_layers(params)):
        h = _layer_with_cache(cfg, h, p, sin, cos, cache["k"][i],
                              cache["v"][i], pos)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = (h @ _w_out(params, cfg)).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + t}


def generate_scan(params, prompt, cfg: LlamaConfig, max_new_tokens: int,
                  cache: dict):
    """Prefill + greedy decode as one Python loop over steps. Returns
    ([B, max_new_tokens] generated tokens, final cache)."""
    logits, cache = forward_with_cache(params, prompt, cfg, cache)
    tok = logits[:, -1:].argmax(dim=-1)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, tok, cfg, cache)
        tok = logits[:, -1:].argmax(dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32), cache


@torch.no_grad()
def greedy_generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int,
                    max_len: int | None = None):
    """Prefill + greedy decode. prompt: [B, T0] -> [B, T0 + max_new_tokens]."""
    b, t0 = prompt.shape
    dev = params["embed"].device
    prompt = prompt.to(dev)
    cache = init_cache(cfg, b, max_len or (t0 + max_new_tokens), device=dev)
    new, _ = generate_scan(params, prompt, cfg, max_new_tokens, cache)
    return torch.cat([prompt.to(torch.int32), new], dim=1)
