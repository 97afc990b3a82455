"""Rank-side halves of the port's multi-rank tests (defines no test).

Each function runs in every rank of a world that ``launch.spawn`` starts
(gloo, one process per rank) and returns that rank's results. Spawned
ranks import this module by name to find the function, so it imports
neither JAX nor ray_tpu: the JAX expectations are computed in the test
process and passed in as numpy arrays.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch import multichip, train
from ray_tpu_torch.collective import mesh_ops
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import ring_attention, ulysses
from ray_tpu_torch.parallel.mesh import (MeshConfig, active_axes, active_mesh,
                                         build_mesh, use_mesh)
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.sharding import NamedSharding, distribute, local_slices
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten


def _guard(results: dict, name: str, fn):
    """Run one case; a failure becomes the case's result, so that the
    other cases still report."""
    try:
        results[name] = fn()
    except Exception:  # reported by the case's own test
        results[name] = {"error": traceback.format_exc()}


def _local(x: torch.Tensor) -> np.ndarray:
    return x.detach().full_tensor().numpy() if isinstance(x, DTensor) \
        else x.detach().numpy()


# --------------------------------------------------------------------------
# The sharded train step (tests/test_torch_parallel_step.py)
# --------------------------------------------------------------------------

def _layout_cfg(layout: dict, **over) -> llama.LlamaConfig:
    moe = dict(n_experts=4, top_k=2) if layout.get("ep", 1) > 1 else {}
    return llama.LlamaConfig.tiny(n_layers=2, remat=False, **moe, **over)


class _Recording(train.optim.FusedAdamW):
    """fused_adamw(lr) that keeps the gradients the step hands it."""

    def __init__(self, lr: float = 1e-3):
        base = train.fused_adamw(lr)
        super().__init__(base.learning_rate, base.b1, base.b2, base.eps,
                         base.weight_decay, base.mu_dtype, base.nu_dtype)
        self.grads = None

    def update(self, grads, state, params):
        self.grads = tree_leaves(grads)
        return super().update(grads, state, params)


def _adamw_bits(params, grads) -> dict:
    """Two sharded FusedAdamW updates of ``params`` (DTensors, updated in
    place; bf16 moments, the second by stochastic rounding) on the same
    gradients against the one-device update of the whole tensors: each
    rank's blocks must equal the one-device update's bit for bit."""
    opt = train.fused_adamw(1e-2, weight_decay=0.01, mu_dtype=torch.bfloat16,
                            nu_dtype=torch.bfloat16)
    # full_tensor() of a replicated DTensor is its local tensor itself
    whole = tree_unflatten(params, [p.full_tensor().clone()
                                    for p in tree_leaves(params)])
    g_tree = tree_unflatten(params, list(grads))
    g_whole = tree_unflatten(params, [g.full_tensor() for g in grads])
    s_sh, s_one = opt.init(params), opt.init(whole)
    for _ in range(2):
        s_sh = opt.update(g_tree, s_sh, params)
        s_one = opt.update(g_whole, s_one, whole)
    unequal = []
    for name, sharded, one in (("params", params, whole), ("mu", s_sh.mu, s_one.mu),
                               ("nu", s_sh.nu, s_one.nu)):
        for path, a, b in zip(tree_paths(sharded), tree_leaves(sharded),
                              tree_leaves(one)):
            block = b[local_slices(b.shape, a.device_mesh, a.placements)]
            if not torch.equal(a.to_local(), block):
                unequal.append(f"{name}/{path}")
    return {"unequal": unequal, "nu_dtype": str(s_sh.nu["embed"].dtype)}


def parallel_step_rank(rank, world, layouts, jax_params, tokens):
    """For each layout (a MeshConfig's fields): the state from JAX's init
    params (``jax_params[i]``, numpy); one sharded step's metrics, the
    gradients it handed the optimizer (rank 0 returns them whole) and
    the shapes its MoE layers saw locally; the local block of wq; the
    sharded optimizer's bits on those gradients. Then the moment
    shardings of test_parallel.py:82 and a pp mesh's refusal of a batch
    that does not split into its microbatches."""
    out = {}
    batch = {"inputs": torch.from_numpy(tokens[:, :-1].copy()),
             "targets": torch.from_numpy(tokens[:, 1:].copy())}
    for layout, np_params in zip(layouts, jax_params):
        key = MeshConfig(**layout).describe()

        def case(layout=layout, np_params=np_params):
            mesh = build_mesh(MeshConfig(**layout))
            cfg = _layout_cfg(layout)
            opt = _Recording()
            state, state_sh = train.init_train_state(
                lambda dev, place: llama.from_jax_params(
                    np_params, cfg, dev, master=True, place=place),
                llama.param_logical_axes(cfg), opt, mesh)
            res = {"wq_local": tuple(state.params["layers"]["wq"].to_local().shape),
                   "wq_global": tuple(state.params["layers"]["wq"].shape)}
            adamw_params = [DTensor.from_local(p.to_local().clone(), p.device_mesh,
                                               p.placements, shape=p.shape,
                                               stride=p.stride())
                            for p in tree_leaves(state.params)]
            seen = []
            plain = llama._MOE_IMPLS["capacity"]

            def recording(cfg_, p, x, first_expert=0):
                seen.append({n: tuple(p[n].shape) for n in llama._MOE_WEIGHTS}
                            | {"x": tuple(x.shape), "first": first_expert})
                return plain(cfg_, p, x, first_expert)

            step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg),
                                         opt, mesh, state_sh)
            llama._MOE_IMPLS["capacity"] = recording
            try:
                state, metrics = step(state, batch)
            finally:
                llama._MOE_IMPLS["capacity"] = plain
            res["moe_local"] = seen
            res["grad_placements_follow_params"] = all(
                tuple(g.placements) == sh.placements
                for g, sh in zip(opt.grads, tree_leaves(state_sh.params)))
            whole = [_local(g) for g in opt.grads]  # a collective: every rank
            if rank == 0:
                res["grads"] = dict(zip(tree_paths(state.params), whole))
            res["adamw"] = _adamw_bits(
                tree_unflatten(state.params, adamw_params), opt.grads)
            res["loss"] = float(metrics["loss"])
            res["grad_norm"] = float(metrics["grad_norm"])
            res["step"] = state.step
            res["metric_types"] = sorted({type(v).__name__ for v in metrics.values()})
            return res

        _guard(out, key, case)

    def moments():
        mesh = build_mesh(MeshConfig(fsdp=4, tp=2))
        cfg = llama.LlamaConfig.tiny(n_heads=4, n_kv_heads=4)
        opt = train.fused_adamw(1e-3, mu_dtype=torch.bfloat16,
                                nu_dtype=torch.bfloat16)
        state, state_sh = train.init_train_state(
            lambda dev, place: llama.init_params(
                cfg, torch.Generator().manual_seed(0), dev, master=True,
                place=place),
            llama.param_logical_axes(cfg), opt, mesh)
        lay, mu, nu = (state.params["layers"], state.opt_state.mu["layers"],
                       state.opt_state.nu["layers"])
        sh = state_sh.opt_state.mu["layers"]
        return {name: {"param": str(lay[name].placements),
                       "mu": str(mu[name].placements),
                       "nu": str(nu[name].placements),
                       "sharding": str(sh[name].placements)}
                for name in ("wq", "wo")}

    _guard(out, "moments", moments)

    def pipeline_refused():
        # the 8 rows do not split into 3 microbatches (JAX's ValueError)
        mesh = build_mesh(MeshConfig(pp=2, fsdp=4))
        cfg = llama.LlamaConfig.tiny(n_layers=2, pipeline_microbatches=3)
        state, _ = train.init_train_state(
            lambda dev, place: llama.init_params(
                cfg, torch.Generator().manual_seed(0), dev, master=True,
                place=place),
            llama.param_logical_axes(cfg), train.fused_adamw(1e-3), mesh)
        try:
            with use_mesh(mesh):
                llama.loss_fn(state.params, batch, cfg)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}

    _guard(out, "pipeline", pipeline_refused)
    return out


# --------------------------------------------------------------------------
# Mesh collectives (tests/test_torch_mesh_ops.py)
# --------------------------------------------------------------------------

def _block(x: np.ndarray, coord, shape) -> np.ndarray:
    """Device (i, j)'s block of a global [4a, 2b] array under P("x", "y")."""
    a, b = x.shape[0] // shape[0], x.shape[1] // shape[1]
    i, j = coord
    return x[i * a:(i + 1) * a, j * b:(j + 1) * b]


def mesh_ops_rank(rank, world, cases, inputs, weights):
    """Each case (name, op, axis, kwargs) on this rank's block of
    ``inputs[name]`` over a (4, 2) mesh named ("x", "y"): the output, and
    for ppermute and all_to_all the gradient of sum(out * weights block)."""
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("x", "y"))
    coord = mesh.get_coordinate()
    out = {}
    for name, op, axis, kw in cases:
        def case(name=name, op=op, axis=axis, kw=kw):
            x = torch.from_numpy(_block(inputs[name], coord, (4, 2)).copy())
            fn = getattr(mesh_ops, op)
            res = {"out": fn(x, mesh, axis, **kw).numpy()}
            if name in weights:
                xg = x.clone().requires_grad_()
                y = fn(xg, mesh, axis, **kw)
                w = torch.from_numpy(_block(weights[name], coord, (4, 2)).copy())
                (y * w).sum().backward()
                res["grad"] = xg.grad.numpy()
                res["bare"] = fn(x, mesh, axis, wrap=False, **kw).numpy()
            return res

        _guard(out, name, case)
    return out


# --------------------------------------------------------------------------
# Ring and Ulysses attention (tests/test_torch_seq_parallel.py)
# --------------------------------------------------------------------------

def _rows(x: np.ndarray, n: int, i: int) -> torch.Tensor:
    t = x.shape[1] // n
    return torch.from_numpy(x[:, i * t:(i + 1) * t].copy())


def seq_parallel_rank(rank, world, ring_cases, ulysses_cases):
    """This rank's rows of ring_attention (on an sp = 8 mesh) and
    ulysses_attention (on each case's mesh) from its rows of q, k, v;
    with ``grad``, the gradients of sum(out**2) (Ulysses) or sum(out)
    (ring) with respect to them."""
    out = {}
    for name, (q, k, v, causal, grad) in ring_cases.items():
        def ring(q=q, k=k, v=v, causal=causal, grad=grad):
            mesh = build_mesh(MeshConfig(sp=world))
            i = mesh.get_local_rank("sp")
            qkv = [_rows(a, world, i).requires_grad_(grad) for a in (q, k, v)]
            o = ring_attention.ring_attention(*qkv, mesh, causal=causal)
            res = {"out": o.detach().numpy()}
            if grad:
                o.sum().backward()
                res["grads"] = [a.grad.numpy() for a in qkv]
            return res

        _guard(out, f"ring/{name}", ring)
    for name, (layout, q, k, v, causal, grad) in ulysses_cases.items():
        def uly(layout=layout, q=q, k=k, v=v, causal=causal, grad=grad):
            mesh = build_mesh(MeshConfig(**layout))
            sp = layout["sp"]
            i = mesh.get_local_rank("sp")
            qkv = [_rows(a, sp, i).requires_grad_(grad) for a in (q, k, v)]
            with use_mesh(mesh):
                o = ulysses.ulysses_attention(*qkv, causal=causal)
            res = {"out": o.detach().numpy(), "sp_index": i}
            if grad:
                (o ** 2).sum().backward()
                res["grads"] = [a.grad.numpy() for a in qkv]
            return res

        _guard(out, f"ulysses/{name}", uly)

    def indivisible():
        mesh = build_mesh(MeshConfig(sp=4, tp=2))
        x = torch.zeros(1, 16, 6, 16)
        try:
            ulysses.ulysses_attention(x, x, x, mesh=mesh)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}

    _guard(out, "ulysses/indivisible_heads", indivisible)
    return out


# --------------------------------------------------------------------------
# GPipe over pp (tests/test_torch_pipeline.py)
# --------------------------------------------------------------------------

def _mlp_layer(h, p):
    return torch.tanh(h @ p["w"] + p["b"])


def _on_pp(tree: dict, mesh) -> dict:
    """Leaves [L, ...] every rank holds whole, as DTensors split over pp
    on dim 0 (replicated elsewhere), requiring grad."""
    amesh = active_mesh(mesh)
    placements = tuple(Shard(0) if a == "pp" else Replicate()
                       for a in active_axes(mesh))
    return {k: distribute(torch.from_numpy(v.copy()),
                          NamedSharding(amesh, placements)).requires_grad_()
            for k, v in tree.items()}


def _pipeline_step_case(rank, layout, np_params, tokens, steps):
    """The sharded train step on a pp mesh: step-1 loss, gradients (rank
    0: whole), the replicated leaves' gradients against the one-device
    step's on this rank, the optimizer's bits, then the losses of
    ``steps`` more steps."""
    mesh = build_mesh(MeshConfig(**layout))
    cfg = llama.LlamaConfig.tiny(n_layers=2, pipeline_microbatches=2)
    batch = {"inputs": torch.from_numpy(tokens[:, :-1].copy()),
             "targets": torch.from_numpy(tokens[:, 1:].copy())}
    opt = _Recording(1e-2)
    state, state_sh = train.init_train_state(
        lambda dev, place: llama.from_jax_params(np_params, cfg, dev, master=True,
                                                 place=place),
        llama.param_logical_axes(cfg), opt, mesh)
    adamw_params = [DTensor.from_local(p.to_local().clone(), p.device_mesh,
                                       p.placements, shape=p.shape, stride=p.stride())
                    for p in tree_leaves(state.params)]
    step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                                 mesh, state_sh)
    state, metrics = step(state, batch)
    res = {"loss": float(metrics["loss"]), "step": state.step,
           "metric_types": sorted({type(v).__name__ for v in metrics.values()}),
           "grad_placements_follow_params": all(
               tuple(g.placements) == sh.placements
               for g, sh in zip(opt.grads, tree_leaves(state_sh.params))),
           "layers_local": tuple(state.params["layers"]["wq"].to_local().shape),
           "moments_follow_params": all(
               tuple(x.placements) == tuple(p.placements)
               for tree in (state.opt_state.mu, state.opt_state.nu)
               for x, p in zip(tree_leaves(tree), tree_leaves(state.params)))}
    whole = dict(zip(tree_paths(state.params), [_local(g) for g in opt.grads]))
    if rank == 0:
        res["grads"] = whole
    one = llama.from_jax_params(np_params, cfg, "cpu", master=True)
    leaves = [p.requires_grad_() for p in tree_leaves(one)]
    loss, _ = llama.loss_fn(tree_unflatten(one, leaves), batch, cfg)
    one_grads = dict(zip(tree_paths(one), [g.numpy() for g in
                                           torch.autograd.grad(loss, leaves)]))
    res["replicated_rel_err"] = {
        path: float(np.linalg.norm(whole[path] - one_grads[path])
                    / np.linalg.norm(one_grads[path]))
        for path in ("embed", "final_norm", "lm_head")}
    res["adamw"] = _adamw_bits(tree_unflatten(state.params, adamw_params),
                               opt.grads)
    res["losses"] = [res["loss"]]
    for _ in range(steps):
        state, metrics = step(state, batch)
        res["losses"].append(float(metrics["loss"]))
    return res


def pipeline_rank(rank, world, mlp, grad_cases, llama_cases, step_case):
    """Every case of tests/test_torch_pipeline.py on this rank (world 8):
    ``pipeline_apply`` of the MLP stack on pp=4, tp=2 (plain inputs); its
    gradients on dp=2, pp=4 (params as DTensors over pp) at each
    microbatch count; ``llama.forward`` on pp=4, fsdp=2 at each
    ``pipeline_microbatches``; the train step on a pp mesh; the two
    ValueErrors."""
    out = {}

    def apply():
        mesh = build_mesh(MeshConfig(pp=4, tp=2))
        params = {k: torch.from_numpy(v.copy()) for k, v in mlp["params"].items()}
        with use_mesh(mesh):
            y = pipeline_apply(_mlp_layer, params, torch.from_numpy(mlp["x"].copy()),
                               num_microbatches=4)
        return {"out": y.numpy()}

    _guard(out, "apply", apply)
    for name, (params, x, m) in grad_cases.items():
        def grads(params=params, x=x, m=m):
            mesh = build_mesh(MeshConfig(dp=2, pp=4))
            p = _on_pp(params, mesh)
            h = torch.from_numpy(x.copy()).requires_grad_()
            with use_mesh(mesh):
                y = pipeline_apply(_mlp_layer, p, h, num_microbatches=m)
            (y ** 2).sum().backward()
            return {"out": y.detach().numpy(), "x": h.grad.numpy(),
                    **{k: v.grad.full_tensor().numpy() for k, v in p.items()}}

        _guard(out, f"grads/{name}", grads)
    for name, (np_params, tokens, mb) in llama_cases.items():
        def forward(np_params=np_params, tokens=tokens, mb=mb):
            mesh = build_mesh(MeshConfig(pp=4, fsdp=2))
            cfg = llama.LlamaConfig.tiny(n_layers=4, pipeline_microbatches=mb)
            state, _ = train.init_train_state(
                lambda dev, place: llama.from_jax_params(
                    np_params, cfg, dev, master=True, place=place),
                llama.param_logical_axes(cfg), train.fused_adamw(1e-3), mesh)
            with use_mesh(mesh), torch.no_grad():
                logits = llama.forward(state.params, torch.from_numpy(tokens),
                                       cfg).full_tensor()
            return {"logits": logits.numpy() if rank == 0 else None}

        _guard(out, f"llama/{name}", forward)
    layout, np_params, tokens, steps = step_case
    _guard(out, "step", lambda: _pipeline_step_case(rank, layout, np_params,
                                                    tokens, steps))

    def errors():
        mesh = build_mesh(MeshConfig(pp=2, fsdp=4))
        raised = []
        for n_layers, batch, m in ((3, 4, 2), (2, 6, 4)):
            p = {"w": torch.zeros(n_layers, 8, 8), "b": torch.zeros(n_layers, 8)}
            try:
                with use_mesh(mesh):
                    pipeline_apply(_mlp_layer, p, torch.zeros(batch, 8),
                                   num_microbatches=m)
                raised.append(None)
            except ValueError as e:
                raised.append(str(e))
        return {"raised": raised}

    _guard(out, "errors", errors)
    return out


# --------------------------------------------------------------------------
# The dry run from the JAX package's inputs (tests/test_torch_multichip.py)
# --------------------------------------------------------------------------

def dryrun_from_jax_rank(rank, world, layouts, inputs):
    """``multichip``'s step of each layout, from (the JAX dry run's params
    as a numpy tree, its tokens [B, SEQ + 1]) in place of the seeded ones;
    rank 0 prints each layout's ``dryrun_multichip ok`` line."""
    losses = []
    for mcfg, (np_params, tokens) in zip(layouts, inputs):
        toks = torch.from_numpy(np.asarray(tokens, np.int64))
        losses.append(multichip._dryrun_one(
            rank, world, mcfg,
            lambda cfg, dev, place: llama.from_jax_params(
                np_params, cfg, dev, master=True, place=place),
            {"inputs": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}))
    return losses


# --------------------------------------------------------------------------
# Shard-local checkpoints (tests/test_torch_train_checkpoint.py)
# --------------------------------------------------------------------------

def checkpoint_rank(rank, world, workdir, jax_path, jax_w):
    """The shard-local cases of tests/test_checkpoint_shardlocal.py, each
    of the 8 ranks a process of a dp=8 mesh; and a sharded checkpoint that
    JAX wrote (one writer, 8 pieces), restored shard by shard."""
    import os

    import torch.distributed as dist

    from ray_tpu_torch.parallel.sharding import spec_to_placements
    from ray_tpu_torch.train import checkpoint as ck

    mesh = build_mesh(MeshConfig(dp=8))
    dp = active_mesh(mesh)
    rows = NamedSharding(dp, (Shard(0),))
    out: dict = {}

    def roundtrip():
        big = torch.arange(8 * 64 * 32, dtype=torch.float32).reshape(8 * 64, 32)
        state = {"w": distribute(big, rows), "step": 7,
                 "scalar": distribute(torch.tensor(3.5), NamedSharding(
                     dp, (Replicate(),)))}
        path = os.path.join(workdir, "roundtrip")
        ck.save_state(state, path)
        dist.barrier()
        stats = {}
        got = ck.restore_state(path, mesh=mesh, stats=stats)
        return {"w": _local(got["w"]), "step": got["step"],
                "scalar": float(_local(got["scalar"])),
                "local_shape": list(got["w"].to_local().shape),
                "bytes_read": stats["bytes_read"],
                "files": sorted(os.listdir(path))}

    def read_fraction():
        big = torch.arange(8 * 64 * 32, dtype=torch.float32).reshape(8 * 64, 32)
        path = os.path.join(workdir, "fraction")
        ck.save_state({"w": distribute(big, rows)}, path)
        dist.barrier()
        reader = ck._ShardReader(path)
        index = local_slices(big.shape, dp, rows.placements)
        shard = ck._load_device_shard(reader, 0, big.shape, np.float32, index)
        reader.close()
        return {"shape": list(shard.shape), "bytes_read": reader.bytes_read,
                "nbytes": big.numel() * 4, "block": shard}

    def reshaped():
        big = torch.arange(8 * 16 * 64, dtype=torch.float32).reshape(8 * 16, 64)
        path = os.path.join(workdir, "reshaped")
        ck.save_state({"w": distribute(big, rows)}, path)
        dist.barrier()
        mesh42 = build_mesh(MeshConfig(dp=4, tp=2))
        sh42 = NamedSharding(active_mesh(mesh42),
                             spec_to_placements(("dp", "tp"), mesh42))
        got = ck.restore_state(path, mesh=mesh42, shardings={"w": sh42})
        return {"w": _local(got["w"]), "placements": [str(p) for p in
                                                      got["w"].placements],
                "local_shape": list(got["w"].to_local().shape)}

    def writers_cover():
        v = torch.arange(64, dtype=torch.int32)
        path = os.path.join(workdir, "cover")
        ck.save_state({"v": distribute(v, rows)}, path)
        dist.barrier()
        with open(os.path.join(path, "meta.msgpack"), "rb") as f:
            meta = ck.unpackb(f.read())
        got = ck.restore_state(path, device="cpu")
        return {"v": got["v"].numpy(), "n_writers": meta["n_writers"],
                "files": sorted(os.listdir(path))}

    def jax_written():
        stats = {}
        got = ck.restore_state(jax_path, shardings={
            "w": rows, "b": NamedSharding(dp, (Replicate(),))}, stats=stats)
        block = local_slices(jax_w.shape, dp, rows.placements)
        return {"w_block": got["w"].to_local().numpy(),
                "want_block": jax_w[block], "b": _local(got["b"]),
                "bytes_read": stats["bytes_read"]}

    for name, fn in (("roundtrip", roundtrip), ("read_fraction", read_fraction),
                     ("reshaped", reshaped), ("writers_cover", writers_cover),
                     ("jax_written", jax_written)):
        _guard(out, name, fn)
        dist.barrier()
    return out
