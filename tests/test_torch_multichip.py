"""The port's multi-device dry run on gloo ranks, against the JAX dry run.

``dryrun_multichip(n, device="cpu")`` runs the JAX package's two layouts
in one world of n ranks: n factored into tp, sp, ep (the MoE model),
fsdp and dp, then, for even n, a two-stage GPipe pipeline over pp with
fsdp and dp for the rest. Rank 0 prints a ``dryrun_multichip ok`` line
for each layout once every rank has the same loss.

- At 8 ranks from the port's seeded params: each layout's loss equals the
  one-process port's loss on the same params and batch within rtol 2e-4
  (f32; sums in other orders over other splits, as
  tests/test_parallel.py:72).
- At 8 and at 4 ranks from the JAX dry run's own params and tokens
  (``__graft_entry__._dryrun_one``'s PRNGKey(0) init and PRNGKey(1)
  tokens, through ``multichip``'s step by
  ``test_torch_dist_ranks.dryrun_from_jax_rank``): each layout's step-1
  loss equals the loss that ``_dryrun_one`` prints for the same mesh
  within rtol 2e-4. The loss is
  taken before the update, so optax's adamw against the port's
  ``fused_adamw`` does not enter.
"""

import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu_torch import multichip, train
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import launch

import test_torch_dist_ranks as ranks


def _ok_lines(out: str) -> list[str]:
    return [x for x in out.splitlines() if x.startswith("dryrun_multichip ok")]


def test_dryrun_multichip_on_8_ranks(capfd):
    losses = multichip.dryrun_multichip(8, device="cpu")
    layouts = multichip.dryrun_layouts(8)
    assert [m.describe() for m in layouts] == ["ep=2xsp=2xtp=2",
                                               "dp=2xpp=2xfsdp=2"]
    assert _ok_lines(capfd.readouterr().out) == [
        f"dryrun_multichip ok: mesh={m.describe()} loss={loss:.4f} step=1"
        for m, loss in zip(layouts, losses)]

    for mcfg, loss in zip(layouts, losses):
        cfg = multichip.dryrun_config(mcfg)
        opt = train.fused_adamw(1e-3)
        state = train.init_train_state(
            lambda dev: multichip.dryrun_params(cfg, dev), opt, device="cpu")
        step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                                     device="cpu")
        _, metrics = step(state, multichip.dryrun_batch(mcfg, cfg.vocab_size))
        np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=2e-4)
        assert torch.isfinite(metrics["grad_norm"])
    assert multichip.dryrun_config(layouts[0]).n_experts == 4
    assert multichip.dryrun_config(layouts[1]).pipeline_microbatches == 2


def _jax_layout(mcfg) -> tuple[float, tuple]:
    """The JAX dry run of one layout: the loss its line prints, and the
    params and tokens it ran on (as ``_dryrun_one`` makes them)."""
    jmcfg = JMeshConfig(**{a: getattr(mcfg, a) for a in
                           ("dp", "pp", "fsdp", "ep", "sp", "tp")})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft._dryrun_one(jmcfg, jax.devices()[:mcfg.size],
                          pipelined=mcfg.pp > 1)
    line, = _ok_lines(buf.getvalue())
    assert f"mesh={mcfg.describe()} " in line
    loss = float(re.search(r"loss=(\S+)", line).group(1))
    cfg = multichip.dryrun_config(mcfg)
    jcfg = jl.LlamaConfig.tiny(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                               n_kv_heads=2, d_ff=128, dtype="float32",
                               n_experts=cfg.n_experts, top_k=2,
                               pipeline_microbatches=cfg.pipeline_microbatches)
    params = jax.tree_util.tree_map(np.asarray, jl.init_params(
        jcfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (multichip.dryrun_batch_size(mcfg),
                                multichip.SEQ + 1), 0, jcfg.vocab_size,
        dtype=jax.numpy.int32))
    return loss, (params, tokens)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_layouts_match_jax(n, capfd):
    layouts = multichip.dryrun_layouts(n)
    assert len(layouts) == 2 and layouts[1].pp == 2
    jax_side = [_jax_layout(m) for m in layouts]
    capfd.readouterr()
    losses = launch.spawn(ranks.dryrun_from_jax_rank, n, layouts,
                          [inp for _, inp in jax_side], device="cpu")[0]
    assert _ok_lines(capfd.readouterr().out) == [
        f"dryrun_multichip ok: mesh={m.describe()} loss={loss:.4f} step=1"
        for m, loss in zip(layouts, losses)]
    np.testing.assert_allclose(losses, [loss for loss, _ in jax_side], rtol=2e-4)
