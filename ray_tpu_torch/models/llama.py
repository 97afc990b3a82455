"""Llama-family decoder-only transformer, dense or mixture-of-experts,
in PyTorch.

Mirrors ray_tpu/models/llama.py: the same config fields and named sizes,
the same parameter tree (layer weights stacked along axis 0, so a JAX
tree converts key for key), the same GQA + RoPE + SwiGLU + RMSNorm
pre-norm block, and the same MoE MLP (``n_experts > 0``): a top-k
router, then either GShard capacity routing with per-row expert buffers
(``moe_impl="capacity"``) or every expert on every token, masked by the
gates (``"dense"``). Weights keep JAX's ``x @ W`` orientation
([d_in, d_out]).

Differences in idiom: parameters are a dict of tensors on an explicit
device. For serving, matmul weights and the embedding are held in the
compute dtype and norm weights in f32; for training (``master=True``)
every leaf is an f32 master, as JAX's are. Weights are cast per use
(``.to(cfg.compute_dtype)``, a no-op for weights already in it). The KV
cache is updated IN PLACE (JAX's functional ``dynamic_update_slice``
becomes a slice write) and the layer "scan" is a Python loop. Remat maps
JAX's checkpoint policies onto ``torch.utils.checkpoint`` with selective
checkpointing (``_REMAT_POLICIES``).

On a device mesh (params that are DTensors, under ``parallel.use_mesh``)
the model makes JAX's ``shard_constraint`` calls at the same points, and
each weight product, the attention and the MoE MLP run on every rank's
local blocks (``parallel.sharding.matmul``, ``ops.flash_attention``,
``_moe_on_mesh``: each ep rank computes only its own experts). On a mesh
with pp > 1 the layer stack runs as a GPipe pipeline over pp
(``parallel.pipeline.pipeline_apply``) in ``pipeline_microbatches``
microbatches (0: the largest divisor of the batch that is at most 4 x pp,
as in JAX).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import _repeat_kv, attention
from ray_tpu_torch.ops.losses import softmax_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rotary, rotary_embedding
from ray_tpu_torch.parallel.mesh import current_mesh
from ray_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_stages
from ray_tpu_torch.parallel.sharding import (local_slices, matmul,
                                             shard_constraint, to_mesh)
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
    # Mixture-of-experts MLP (0 = dense MLP): top_k of n_experts experts
    # per token, routed by moe_impl ("capacity" or "dense"); each expert's
    # buffer per batch row holds ceil(top_k * T / E * capacity_factor)
    # tokens, and tokens routed past a full buffer are dropped (the
    # residual still carries them).
    n_experts: int = 0
    top_k: int = 2
    moe_impl: str = "capacity"
    capacity_factor: float = 1.25
    pipeline_microbatches: int = 0  # GPipe microbatches on a pp mesh (0: auto)

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
        if self.n_experts > 0:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
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


def llama2_7b() -> LlamaConfig:
    return llama2_size("7b")


def llama2_size(name: str) -> LlamaConfig:
    """Named sizes: '125m', 'moe-tiny', '350m', '1b', '7b'."""
    table = {
        "125m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, d_ff=2048),
        "moe-tiny": dict(d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab_size=512, max_seq_len=128,
                         n_experts=4, top_k=2),
        "350m": dict(d_model=1024, n_layers=24, n_heads=8, n_kv_heads=8, d_ff=2816),
        "1b": dict(d_model=2048, n_layers=22, n_heads=16, n_kv_heads=8, d_ff=5632),
        "7b": dict(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32, d_ff=11008),
    }
    return LlamaConfig(**table[name])


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _shapes(cfg: LlamaConfig) -> dict:
    d, f, hd, e = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_experts
    hq, hkv, l = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layers = {
        "attn_norm": (l, d),
        "wq": (l, d, hq * hd), "wk": (l, d, hkv * hd), "wv": (l, d, hkv * hd),
        "wo": (l, hq * hd, d),
        "mlp_norm": (l, d),
    }
    if e > 0:
        layers.update(router=(l, d, e), w_gate=(l, e, d, f),
                      w_up=(l, e, d, f), w_down=(l, e, f, d))
    else:
        layers.update(w_gate=(l, d, f), w_up=(l, d, f), w_down=(l, f, d))
    out = {"embed": (cfg.vocab_size, d), "layers": layers, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    return out


def _keep(path: str, leaf: torch.Tensor) -> torch.Tensor:
    return leaf


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device=None, master: bool = False, place=_keep) -> dict:
    """Random params with JAX's init law: embed ~ N(0, 1), each dense
    weight ~ N(0, 1/fan_in) (fan_in: the contracted dimension, the
    second-to-last), norms 1. Drawn in f32 from ``generator``
    (seed 0 on the target device when None). Matmul weights and the
    embedding are then cast to the compute dtype (norms stay f32), or,
    with ``master=True``, every leaf stays f32 (training masters). Each
    leaf goes through ``place(path, leaf)`` as soon as it is made (the
    sharded init of ``train.init_train_state`` keeps a block of it)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cdt = torch.float32 if master else cfg.compute_dtype

    def normal(path, shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        if fan_in:
            x /= math.sqrt(fan_in)
        return place(path, x.to(dev, cdt))

    def ones(path, shape):
        return place(path, torch.ones(shape, dtype=torch.float32, device=dev))

    shapes = _shapes(cfg)
    layers = {}
    for name, shape in shapes["layers"].items():
        path = f"layers/{name}"
        layers[name] = (ones(path, shape) if name in _NORMS
                        else normal(path, shape, shape[-2]))
    params = {
        "embed": normal("embed", shapes["embed"], 0),
        "layers": layers,
        "final_norm": ones("final_norm", shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = normal("lm_head", shapes["lm_head"], cfg.d_model)
    return params


def from_jax_params(np_tree: dict, cfg: LlamaConfig, device=None,
                    master: bool = False, place=_keep) -> dict:
    """Convert ray_tpu's JAX param tree, given as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), into this module's.

    Same keys and stacked [L, ...] shapes; weights keep the ``x @ W``
    orientation [d_in, d_out], so nothing is transposed. Matmul weights
    and the embedding go to the compute dtype, norms to f32; with
    ``master=True`` every leaf stays f32. Each leaf goes through
    ``place(path, leaf)``, as in ``init_params``."""
    dev = resolve_device(device)
    shapes = _shapes(cfg)
    wdt = torch.float32 if master else cfg.compute_dtype

    def conv(path, a, shape, is_norm):
        a = np.array(a, np.float32)  # a writable copy the tensor can own
        if a.shape != tuple(shape):
            raise ValueError(f"param shape {a.shape} != expected {shape}")
        return place(path, torch.from_numpy(a).to(
            dev, torch.float32 if is_norm else wdt))

    out = {
        "embed": conv("embed", np_tree["embed"], shapes["embed"], False),
        "layers": {k: conv(f"layers/{k}", np_tree["layers"][k], s, k in _NORMS)
                   for k, s in shapes["layers"].items()},
        "final_norm": conv("final_norm", np_tree["final_norm"],
                           shapes["final_norm"], True),
    }
    if "lm_head" in shapes:
        out["lm_head"] = conv("lm_head", np_tree["lm_head"], shapes["lm_head"],
                              False)
    return out


def param_logical_axes(cfg: LlamaConfig) -> dict:
    """The tree of init_params with, at each leaf, the logical axis names
    of its dimensions (JAX's, for the sharding rules of a mesh)."""
    layers = {
        "attn_norm": ("layers", "norm"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "norm"),
    }
    if cfg.n_experts > 0:
        layers.update(router=("layers", "embed", None),
                      w_gate=("layers", "expert", "embed", "mlp"),
                      w_up=("layers", "expert", "embed", "mlp"),
                      w_down=("layers", "expert", "mlp", "embed"))
    else:
        layers.update(w_gate=("layers", "embed", "mlp"),
                      w_up=("layers", "embed", "mlp"),
                      w_down=("layers", "mlp", "embed"))
    axes = {"embed": ("vocab", "embed"), "layers": layers,
            "final_norm": ("norm",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


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
    casts it before its gather); on a mesh from a replicated table, as
    JAX gathers it (ray_tpu/models/llama.py:374)."""
    w = shard_constraint(params["embed"].to(cfg.compute_dtype), (None, None))
    return w[tokens.long()]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _qkv(cfg: LlamaConfig, p, h, sin, cos):
    """Pre-norm QKV projection + rotary, shared by every layer variant."""
    b, t, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    x = rms_norm(h, p["attn_norm"], cfg.rms_eps)
    q = matmul(x, p["wq"].to(cdt)).reshape(b, t, hq, hd)
    k = matmul(x, p["wk"].to(cdt)).reshape(b, t, hkv, hd)
    v = matmul(x, p["wv"].to(cdt)).reshape(b, t, hkv, hd)
    return apply_rotary(q, sin, cos), apply_rotary(k, sin, cos), v


def moe_gates(cfg: LlamaConfig, router, x):
    """Router probabilities with top-k masking, [B, T, E] f32: the
    softmax of ``x @ router`` with every prob below the k-th largest set
    to 0, renormalised. Probs that tie at the k-th value all survive, so
    a row may keep more than top_k entries."""
    logits = matmul(x, router.to(cfg.compute_dtype))  # [B, T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    if cfg.top_k < cfg.n_experts:
        kth = torch.sort(probs, dim=-1).values[..., -cfg.top_k, None]
        probs = torch.where(probs >= kth, probs, 0.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    return probs


def _moe_mlp_dense(cfg: LlamaConfig, p, x, first_expert: int = 0):
    """Every expert computes every token; the gates weight the sum. The
    parity oracle of the capacity path: with no drops both compute the
    same weighted sum. gate and up are ``x @ W`` over the experts'
    weights laid side by side, one no-batch product (``aten.mm``) each,
    which the "dots" remat policies save as JAX's save its ``btd,edf``
    einsums; the other products are batched and recomputed. The expert
    weights may be a block of ``e`` experts from ``first_expert`` on (one
    rank's under ep), whose share of the sum this returns."""
    cdt = cfg.compute_dtype
    b, t, d = x.shape
    e, f = p["w_gate"].shape[0], cfg.d_ff
    gates = moe_gates(cfg, p["router"], x).to(cdt)  # [B, T, E]
    gates = gates[..., first_expert:first_expert + e]

    def all_experts(w):  # "btd,edf->btef"
        return (x @ w.to(cdt).transpose(0, 1).reshape(d, e * f)).reshape(
            b, t, e, f)

    gate, up = all_experts(p["w_gate"]), all_experts(p["w_up"])
    y = torch.einsum("btef,efd->bted", F.silu(gate) * up, p["w_down"].to(cdt))
    return torch.einsum("bted,bte->btd", y, gates)


def moe_capacity(cfg: LlamaConfig, t: int) -> int:
    """Token slots each expert owns per batch row of ``t`` tokens:
    ceil(top_k * t / E * capacity_factor), at most t * top_k."""
    k, e = cfg.top_k, cfg.n_experts
    return min(t * k, int(math.ceil(k * t / e * cfg.capacity_factor)))


def _capacity_slots(cfg: LlamaConfig, gates, capacity: int):
    """GShard slot assignment. gates [B, T, E] f32 (``moe_gates``) ->
    (topv [B, T, k] f32, topi [B, T, k], pos [B, T, k] int32): each
    token's k choices by descending gate, lower expert index first among
    equal gates (``jax.lax.top_k``'s order, from a stable sort), and the
    slot each choice takes in its expert's buffer. Slots fill in token
    order, all first choices of the row before any second choice; a slot
    >= ``capacity`` means the choice is dropped."""
    e, k = cfg.n_experts, cfg.top_k
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    counts = torch.zeros(gates.shape[0], 1, e, dtype=torch.int32,
                         device=gates.device)
    pos = []
    for j in range(k):
        mask_j = F.one_hot(topi[..., j], e).to(torch.int32)  # [B, T, E]
        slot = torch.cumsum(mask_j, dim=1, dtype=torch.int32) - mask_j + counts
        counts = counts + mask_j.sum(dim=1, keepdim=True, dtype=torch.int32)
        pos.append((slot * mask_j).sum(dim=-1, dtype=torch.int32))
    return topv, topi, torch.stack(pos, dim=-1)


def _moe_mlp_capacity(cfg: LlamaConfig, p, x, first_expert: int = 0):
    """GShard top-k capacity routing: per batch row, each expert owns
    ``moe_capacity(cfg, T)`` token slots (``_capacity_slots``); one-hot
    dispatch and combine tensors make the layer dense products:

        xe [B,E,C,D] = dispatch [B,T,E,C] . x [B,T,D]
        ye [B,E,C,D] = expert_mlp(xe)
        y  [B,T,D]   = combine  [B,T,E,C] . ye

    A dropped choice gets an all-zero dispatch and combine row (where
    ``jax.nn.one_hot`` of an out-of-range slot gives zeros, the slot is
    clamped and the row masked). dispatch is built in the compute dtype,
    combine in f32 and cast for the last product, as in JAX. The expert
    weights may be a block of ``e`` experts from ``first_expert`` on (one
    rank's under ep): the slots are assigned over all experts, and only
    the block's buffers are filled and computed."""
    cdt = cfg.compute_dtype
    k = cfg.top_k
    e = p["w_gate"].shape[0]
    capacity = moe_capacity(cfg, x.shape[1])
    gates = moe_gates(cfg, p["router"], x)
    topv, topi, pos = _capacity_slots(cfg, gates, capacity)
    keep = (pos < capacity).to(cdt)
    dispatch = combine = 0
    for j in range(k):
        oh_c = F.one_hot(pos[..., j].clamp(max=capacity - 1).long(),
                         capacity).to(cdt) * keep[..., j, None]
        oh_e = F.one_hot(topi[..., j], cfg.n_experts).to(cdt)
        contrib = oh_e[..., first_expert:first_expert + e, None] * oh_c[..., None, :]
        dispatch = dispatch + contrib
        combine = combine + contrib.float() * topv[..., j, None, None]
    xe = torch.einsum("btec,btd->becd", dispatch, x.to(cdt))
    gate = torch.einsum("becd,edf->becf", xe, p["w_gate"].to(cdt))
    up = torch.einsum("becd,edf->becf", xe, p["w_up"].to(cdt))
    ye = torch.einsum("becf,efd->becd", F.silu(gate) * up, p["w_down"].to(cdt))
    return torch.einsum("btec,becd->btd", combine.to(cdt), ye)


_MOE_IMPLS = {"dense": _moe_mlp_dense, "capacity": _moe_mlp_capacity}
_MOE_WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def _moe_on_mesh(cfg: LlamaConfig, impl, p, x):
    """The MoE MLP of DTensors, each rank on its local blocks: its batch
    rows, whole (the sequence gathered over sp: a capacity slot is a
    cumsum over the row), its experts (E split over ep) and its block of
    d_ff (split over tp). No expert weight is gathered over ep or tp,
    only over fsdp. The output is a pending sum over the ep and tp ranks
    (each holds its experts' and its d_ff block's share)."""
    x = shard_constraint(x, ("batch", None, "embed"))
    w = {name: p[name] for name in _MOE_WEIGHTS}
    kept = {"router": (), "w_gate": (0, 2), "w_up": (0, 2), "w_down": (0, 1)}
    w_in = {name: tuple(pl if isinstance(pl, Shard) and pl.dim in kept[name]
                        else Replicate() for pl in w[name].placements)
            for name in _MOE_WEIGHTS}
    x_in, out, d_router = [], [], []
    for m, px in enumerate(x.placements):
        batch = px == Shard(0)
        split = w_in["w_gate"][m] != Replicate()  # experts or d_ff
        x_in.append(Shard(0) if batch else Replicate())
        out.append(Partial() if split else x_in[-1])
        d_router.append(Partial() if batch or split else Replicate())
    d_w = {name: tuple(Partial() if x_in[m] == Shard(0) else pl
                       for m, pl in enumerate(w_in[name]))
           for name in _MOE_WEIGHTS}
    d_w["router"] = tuple(d_router)
    mesh = x.device_mesh
    first = local_slices(w["w_gate"].shape, mesh, w_in["w_gate"])[0].start

    def local(x_, *weights):
        return impl(cfg, dict(zip(_MOE_WEIGHTS, weights)), x_, first)

    run = local_map(local, out_placements=(tuple(out),),
                    in_placements=(tuple(x_in),) + tuple(w_in[n] for n in _MOE_WEIGHTS),
                    in_grad_placements=(tuple(out),) + tuple(d_w[n] for n in _MOE_WEIGHTS),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(x, *(w[n] for n in _MOE_WEIGHTS))


def _moe_mlp(cfg: LlamaConfig, p, x):
    if cfg.moe_impl not in _MOE_IMPLS:
        raise ValueError(
            f"unknown moe_impl {cfg.moe_impl!r}; expected 'capacity' or 'dense'")
    impl = _MOE_IMPLS[cfg.moe_impl]
    if isinstance(x, DTensor):
        return shard_constraint(_moe_on_mesh(cfg, impl, p, x),
                                ("batch", "seq", "embed"))
    return impl(cfg, p, x)


def _attn_out_and_mlp(cfg: LlamaConfig, p, h, o):
    """wo projection + residual + MLP + residual: the MoE MLP when
    ``cfg.n_experts > 0`` (no checkpoint names, as in JAX), else the dense
    SwiGLU, whose gate and up carry the reference's checkpoint names
    (mlp_gate, mlp_up)."""
    b, t, _ = h.shape
    cdt = cfg.compute_dtype
    h = h + shard_constraint(
        matmul(o.reshape(b, t, cfg.n_heads * cfg.head_dim), p["wo"].to(cdt)),
        ("batch", "seq", "embed"))
    x = rms_norm(h, p["mlp_norm"], cfg.rms_eps)
    if cfg.n_experts > 0:
        return h + _moe_mlp(cfg, p, x)
    w_gate, w_up = p["w_gate"].to(cdt), p["w_up"].to(cdt)
    with checkpoint_name("mlp_gate"):
        gate = matmul(x, w_gate)
    with checkpoint_name("mlp_up"):
        up = matmul(x, w_up)
    y = matmul(F.silu(gate) * up, p["w_down"].to(cdt))
    return h + shard_constraint(y, ("batch", "seq", "embed"))


def _layer(cfg: LlamaConfig, h, p, sin, cos):
    """One pre-norm transformer block. h: [B, T, D] in compute dtype."""
    q, k, v = _qkv(cfg, p, h, sin, cos)
    q = shard_constraint(q, ("batch", "seq", "heads", "head_dim"))
    k = shard_constraint(k, ("batch", "seq", "kv_heads", "head_dim"))
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
    ``aten.mm`` (jax's dots_with_no_batch_dims). Batched products are
    ``bmm`` and are recomputed: attention's, and every MoE einsum but the
    router's and the dense impl's gate and up, which are ``mm`` as their
    JAX einsums have no batch dimension."""
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
    changes memory and time, never values. Under a mesh the params are
    DTensors; tokens and positions every rank holds whole are placed by
    the rules (the rotary tables of global positions split as the
    sequence is). On a mesh with pp > 1 the layers run as a GPipe
    pipeline over pp; each stage places the tables on its own submesh
    once a call."""
    b, t = tokens.shape
    dev = params["embed"].device
    tokens = to_mesh(tokens.to(dev), ("batch", "seq"))
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    # the tables of global positions, split on the mesh as the sequence is
    table_axes = ("batch" if positions.shape[0] > 1 else None, "seq", None)
    sin, cos = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    layer_fn = functools.partial(_layer, cfg)
    if cfg.remat and torch.is_grad_enabled():
        layer_fn = _remat_layer_fn(cfg)
    h = _embed(params, cfg, tokens)
    h = shard_constraint(h, ("batch", "seq", "embed"))
    pp = pipeline_stages()
    if pp > 1:
        mb = cfg.pipeline_microbatches
        if not mb:  # auto: largest divisor of the batch <= 4 stages' worth
            mb = max(d for d in range(1, min(b, 4 * pp) + 1) if b % d == 0)
        placed = {}  # the tables on each stage's submesh, placed once

        def stage_layer(c, p):
            mesh = current_mesh()
            if mesh not in placed:
                placed[mesh] = (to_mesh(sin, table_axes), to_mesh(cos, table_axes))
            return layer_fn(c, p, *placed[mesh])

        h = pipeline_apply(stage_layer, params["layers"], h, num_microbatches=mb)
    else:
        sin, cos = to_mesh(sin, table_axes), to_mesh(cos, table_axes)
        for p in _unbind_layers(params):
            h = layer_fn(h, p, sin, cos)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return shard_constraint(matmul(h, _w_out(params, cfg)),
                            ("batch", "seq", "vocab"))


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
    # on a mesh the loss takes whole vocab rows (gathered over tp)
    logits = shard_constraint(forward(params, inputs, cfg), ("batch", "seq", None))
    targets = to_mesh(targets.to(logits.device), ("batch", "seq"))
    if mask is not None:
        mask = to_mesh(mask.to(logits.device), ("batch", "seq"))
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


def draft_config(cfg: LlamaConfig, n_layers: int) -> LlamaConfig:
    """Config of the shared-trunk draft: the target's first ``n_layers``
    blocks with its own final norm and unembedding, so the draft's logits
    live in the target's token space."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"draft depth {n_layers} outside [1, {cfg.n_layers}]")
    return LlamaConfig(**{**cfg.__dict__, "n_layers": n_layers})


def draft_params(params, n_layers: int) -> dict:
    """Weight VIEW of the shared-trunk draft: the embedding, the first
    ``n_layers`` stacked blocks (slices of the target's tensors, no copy),
    the final norm and, when untied, the lm_head. The draft's layer-i k/v
    for a position equals the target's (the same weights on the same
    prefix), which is why speculative decoding lets the draft read the
    target's cache (``decode_engine.decode_chunk_spec``)."""
    out = {"embed": params["embed"],
           "layers": {k: v[:n_layers] for k, v in params["layers"].items()},
           "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


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
