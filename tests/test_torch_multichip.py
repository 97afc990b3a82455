"""The port's multi-device dry run on 8 gloo ranks.

``dryrun_multichip(8, device="cpu")`` factors 8 as the JAX package's
dry run does (tp=2, sp=2, ep=2: the MoE model) and takes one sharded
step; rank 0 prints the ``dryrun_multichip ok`` line once every rank has
the same loss. That loss must equal the one-process port's loss on the
same params and batch within rtol 2e-4 (f32; sums in other orders over
other splits, as tests/test_parallel.py:72).
"""

import numpy as np
import torch

from ray_tpu_torch import multichip, train
from ray_tpu_torch.models import llama


def test_dryrun_multichip_on_8_ranks(capfd):
    loss = multichip.dryrun_multichip(8, device="cpu")
    out = capfd.readouterr().out
    lines = [x for x in out.splitlines() if x.startswith("dryrun_multichip ok")]
    assert lines == [f"dryrun_multichip ok: mesh=ep=2xsp=2xtp=2 "
                     f"loss={loss:.4f} step=1"]

    mcfg = multichip.dryrun_mesh_config(8)
    cfg = multichip.dryrun_config(mcfg)
    opt = train.fused_adamw(1e-3)
    state = train.init_train_state(
        lambda dev: multichip.dryrun_params(cfg, dev), opt, device="cpu")
    step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                                 device="cpu")
    _, metrics = step(state, multichip.dryrun_batch(mcfg, cfg.vocab_size))
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=2e-4)
    assert cfg.n_experts == 4 and torch.isfinite(metrics["grad_norm"])
