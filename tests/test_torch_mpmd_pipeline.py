"""The port's MPMD pipeline against the JAX package's, in one process.

``ray_tpu_torch.parallel.MpmdPipeline`` runs each (stage, dp replica) on
a thread of ``InProcessPipelineRuntime``. Held here:

- ``PipelineSchedule``: actions, warmup, peak_live and bubble_fraction
  equal to JAX's for S <= 4 stages and M <= 8 microbatches, both styles.
- JAX's toy stages and numpy baseline (tests/test_mpmd_pipeline.py:97-148,
  copied): 1F1B and GPipe losses and params bit-equal to the baseline
  (each worker sums its gradients in ascending microbatch order, as the
  baseline does); asymmetric [1, 2] workers within atol 1e-12 (the stage
  sum reorders the addition).
- Heal in place: a stage worker killed mid-step (the fault site's
  ``exit``) or failing with ``die``, and a dropped boundary send (the peer
  times out with the typed ``CollectiveTimeoutError``), each heal once,
  with no gang restart, losses equal to the baseline, and no worker
  thread left behind.
- Checkpoints: a torn or altered member raises ``CheckpointCorruptError``
  before unpickling; a checkpoint written by
  ``ray_tpu.train.checkpoint.Checkpoint.from_dict`` reads in the port,
  and the port's reads in the JAX package's.
- A two-stage tiny Llama in torch (f32, ``LlamaConfig.tiny(n_layers=4)``,
  the stage functions below, as JAX's test keeps its own): losses and
  final params against the port's one-device accumulated step (rtol
  1e-5), and each step-1 gradient, summed over the microbatches, against
  JAX's ``llama.loss_fn`` gradients on the same params (rtol 1e-5, atol
  1e-5 x the leaf's largest gradient).
"""

import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import PipelineSchedule as JPipelineSchedule
from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.losses import softmax_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rotary_embedding
from ray_tpu_torch.parallel import MpmdPipeline, PipelineSchedule, StageSpec
from ray_tpu_torch.parallel.pipeline_runtime import InProcessPipelineRuntime
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointCorruptError
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["1f1b", "gpipe"])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_schedule_matches_jax(style, stages):
    for mbs in range(1, 9):
        ours = PipelineSchedule(stages, mbs, style)
        theirs = JPipelineSchedule(stages, mbs, style)
        assert ours.bubble_fraction() == theirs.bubble_fraction()
        for s in range(stages):
            assert ours.actions(s) == theirs.actions(s)
            assert ours.warmup(s) == theirs.warmup(s)
            assert ours.peak_live(s) == theirs.peak_live(s)


def test_schedule_rejects_what_jax_rejects():
    for args in ((2, 4, "zigzag"), (0, 4), (2, 0)):
        with pytest.raises(ValueError):
            JPipelineSchedule(*args)
        with pytest.raises(ValueError):
            PipelineSchedule(*args)


# ---------------------------------------------------------------------------
# JAX's toy model (2 matmul stages) and sequential baseline
# ---------------------------------------------------------------------------

D0, D1, D2, B = 6, 5, 4, 8
LR = 0.05


def data_fn(step, m):
    rng = np.random.default_rng(1000 + step * 100 + m)
    return (rng.standard_normal((B, D0)), rng.standard_normal((B, D2)))


def init0(cfg):
    return {"w": np.random.default_rng(7).standard_normal((D0, D1))}


def init1(cfg):
    return {"w": np.random.default_rng(8).standard_normal((D1, D2))}


def fwd(params, x):
    return x @ params["w"], x


def bwd(params, x, dy):
    return dy @ params["w"].T, {"w": x.T @ dy}


def loss_fn(params, y, t):
    d = y - t
    return 0.5 * float(np.mean(d * d)), d / d.size


def baseline(steps, mbs):
    """Single-slice sequential reference: same math, no pipeline."""
    p0, p1 = init0({}), init1({})
    losses = []
    for step in range(steps):
        g0 = np.zeros_like(p0["w"])
        g1 = np.zeros_like(p1["w"])
        ls = []
        for m in range(mbs):
            x, t = data_fn(step, m)
            y0, s0 = fwd(p0, x)
            y1, s1 = fwd(p1, y0)
            loss, dy = loss_fn(p1, y1, t)
            ls.append(loss)
            dx1, gg1 = bwd(p1, s1, dy)
            _, gg0 = bwd(p0, s0, dx1)
            g0 += gg0["w"]
            g1 += gg1["w"]
        p0["w"] = p0["w"] - LR * g0 / mbs
        p1["w"] = p1["w"] - LR * g1 / mbs
        losses.append(sum(ls) / len(ls))
    return losses, p0, p1


def _toy(**kw) -> MpmdPipeline:
    sizes = kw.pop("sizes", (1, 1))
    return MpmdPipeline([StageSpec(sizes[0], init0, fwd, bwd),
                         StageSpec(sizes[1], init1, fwd, bwd, loss_fn)],
                        data_fn=data_fn, lr=LR, **kw)


def _pipeline_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if "-stage" in t.name or t.name == "pipeline_allreduce"]


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_toy_pipeline_is_bit_equal_to_baseline(schedule):
    res = _toy(num_steps=3, microbatches=4, schedule=schedule,
               return_params=True).fit()
    bl, p0, p1 = baseline(3, 4)
    assert res.steps_completed == 3
    assert res.heals == 0 and res.gang_restarts == 0
    assert res.stage_world_sizes == [1, 1]
    np.testing.assert_array_equal(res.losses, bl)
    np.testing.assert_array_equal(res.final_params[0]["w"], p0["w"])
    np.testing.assert_array_equal(res.final_params[1]["w"], p1["w"])
    assert sorted(res.bubble_by_stage) == [0, 1]
    assert all(0.0 <= b < 1.0 for b in res.bubble_by_stage.values())
    assert _pipeline_threads() == []


def test_toy_pipeline_asymmetric_dp():
    res = _toy(sizes=(1, 2), num_steps=2, microbatches=4,
               return_params=True).fit()
    bl, p0, p1 = baseline(2, 4)
    assert res.stage_world_sizes == [1, 2]
    np.testing.assert_allclose(res.losses, bl, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.final_params[0]["w"], p0["w"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.final_params[1]["w"], p1["w"], rtol=0, atol=1e-12)
    assert _pipeline_threads() == []


class _Spans:
    def __init__(self):
        self.spans = []

    def record(self, cat, name, t0, t1, attrs=None):
        self.spans.append((name, attrs))


class _SeenErrors(InProcessPipelineRuntime):
    """The in-process runtime, keeping the error types its workers gave."""

    def __init__(self, recorder):
        super().__init__(recorder)
        self.errors = []

    def results(self, timeout):
        out = super().results(timeout)
        self.errors += [r["error_type"] for _, r in out if r["type"] == "error"]
        return out


@pytest.mark.parametrize("action,match,cause,stages", [
    ("exit", {"rank": 1}, "WorkerDiedError", [1]),
    ("die", {"rank": 1}, "InjectedFault", [1]),
    ("drop", {"rank": 1, "op": "send"}, "CollectiveTimeoutError", []),
], ids=["exit", "die", "drop"])
def test_stage_fault_heals_in_place(tmp_path, action, match, cause, stages):
    """A fault at stage 1's boundary in step 2 of 5: every stage quiesces,
    the groups reform under epoch 2, and all resume from step 1, the last
    step both checkpointed."""
    spans = _Spans()
    runtime = _SeenErrors(spans)
    res = _toy(num_steps=5, microbatches=4, ckpt_dir=str(tmp_path / "ck"),
               ckpt_every=1, p2p_timeout_s=1.0, quiesce_timeout_s=5.0,
               poll_s=0.5, runtime=runtime,
               fault_specs=[{"site": "pipeline.stage", "match": match,
                             "after": 10 if action != "drop" else 5,
                             "action": action, "count": 1}]).fit()
    bl, _, _ = baseline(5, 4)
    assert res.heals == 1 and res.gang_restarts == 0
    assert res.steps_completed == 5
    np.testing.assert_array_equal(res.losses, bl)
    assert runtime.errors[0] == cause
    heal = [a for name, a in spans.spans if name == "pipeline.heal"]
    assert len(heal) == 1
    assert heal[0]["stages"] == stages
    assert heal[0]["epoch"] == 2 and heal[0]["resume_step"] == 1
    assert _pipeline_threads() == []
    assert sorted(os.listdir(tmp_path / "ck" / "stage0")) == [
        "step_000004", "step_000005"]  # two kept


def test_heal_budget_is_respected(tmp_path):
    with pytest.raises(RuntimeError, match="heal budget exhausted"):
        _toy(num_steps=3, microbatches=4, max_heals=0, p2p_timeout_s=1.0,
             poll_s=0.5, fault_specs=[{"site": "pipeline.stage",
                                       "match": {"rank": 1}, "after": 3,
                                       "action": "die", "count": 1}]).fit()
    assert _pipeline_threads() == []


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_torn_checkpoint_raises(tmp_path):
    ck = Checkpoint.from_dict({"step": 3, "params": {"w": np.arange(6.0)}},
                              path=str(tmp_path / "a"))
    member = os.path.join(ck.path, "user.pkl")
    with open(member, "r+b") as f:
        f.truncate(os.path.getsize(member) // 2)
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        ck.to_dict()
    with open(os.path.join(ck.path, "checksums_d.json"), "w") as f:
        f.write("{torn")
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        ck.to_dict()
    with pytest.raises(CheckpointCorruptError, match="missing"):
        Checkpoint(str(tmp_path / "nothing")).to_dict()


def test_checkpoints_read_across_packages(tmp_path):
    data = {"step": 7, "params": {"w": np.arange(12.0).reshape(3, 4)}}
    JCheckpoint.from_dict(data, path=str(tmp_path / "jax"))
    got = Checkpoint(str(tmp_path / "jax")).to_dict()
    assert got["step"] == 7
    np.testing.assert_array_equal(got["params"]["w"], data["params"]["w"])
    Checkpoint.from_dict(data, path=str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["checksums_d.json", "user.pkl"]
    got = JCheckpoint(str(tmp_path / "port")).to_dict()
    np.testing.assert_array_equal(got["params"]["w"], data["params"]["w"])


# ---------------------------------------------------------------------------
# a two-stage Llama in torch
# ---------------------------------------------------------------------------

LLAMA_CFG = llama.LlamaConfig.tiny(n_layers=4)
SPLIT = 2  # layers of stage 0
LLAMA_M, LLAMA_STEPS, LLAMA_LR = 4, 2, 0.1


def llama_data(step, m):
    toks = np.random.RandomState(100 + 10 * step + m).randint(
        0, LLAMA_CFG.vocab_size, (2, 17)).astype(np.int64)
    return toks[:, :-1], toks[:, 1:]


def _jax_llama_params():
    return jax.tree_util.tree_map(np.asarray, jl.init_params(
        jl.LlamaConfig.tiny(n_layers=4), jax.random.PRNGKey(3)))


def _stage_trees(full):
    """Stage 0: the embedding and layers [0, SPLIT); stage 1: the rest,
    the final norm and the head."""
    return ({"embed": full["embed"],
             "layers": {k: v[:SPLIT] for k, v in full["layers"].items()}},
            {"layers": {k: v[SPLIT:] for k, v in full["layers"].items()},
             "final_norm": full["final_norm"], "lm_head": full["lm_head"]})


def _leaves(params):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    return leaves, tree_unflatten(params, leaves)


def _layers(cfg, p, h, t):
    sin, cos = rotary_embedding(torch.arange(t, dtype=torch.int32)[None, :],
                                cfg.head_dim, cfg.rope_theta)
    layer_fn = llama._remat_layer_fn(cfg) if cfg.remat \
        else functools.partial(llama._layer, cfg)
    for lp in llama._unbind_layers(p):
        h = layer_fn(h, lp, sin, cos)
    return h


def stage0_forward(params, x):
    leaves, p = _leaves(params)
    tokens = torch.from_numpy(x)
    h = _layers(LLAMA_CFG, p, llama._embed(p, LLAMA_CFG, tokens), x.shape[1])
    return h.detach().float().numpy(), (leaves, h)


def stage0_backward(params, saved, dy):
    leaves, h = saved
    grads = torch.autograd.grad(h, leaves, torch.from_numpy(dy).to(h.dtype))
    return None, tree_unflatten(params, list(grads))


def stage1_forward(params, x):
    leaves, p = _leaves(params)
    h_in = torch.from_numpy(x).to(LLAMA_CFG.compute_dtype).requires_grad_()
    h = _layers(LLAMA_CFG, p, h_in, x.shape[1])
    h = rms_norm(h, p["final_norm"], LLAMA_CFG.rms_eps)
    logits = h @ p["lm_head"].to(LLAMA_CFG.compute_dtype)
    return logits, (leaves, h_in, logits)


def stage1_loss(params, y, target):
    loss, _ = softmax_cross_entropy(y, torch.from_numpy(target))
    dy, = torch.autograd.grad(loss, y)
    return float(loss.detach()), dy


def stage1_backward(params, saved, dy):
    leaves, h_in, logits = saved
    grads = torch.autograd.grad(logits, [h_in] + leaves, dy)
    return grads[0].float().numpy(), tree_unflatten(params, list(grads[1:]))


def _recording(backward, log, stage):
    def run(params, saved, dy):
        dx, grads = backward(params, saved, dy)
        log.append((stage, {k: v.numpy().copy() for k, v in
                            zip(tree_paths(grads), tree_leaves(grads))}))
        return dx, grads
    return run


def _one_device(full):
    """The port's one-device accumulated step: llama.loss_fn per
    microbatch, gradients summed in ascending order, times 1/M, SGD."""
    params = {k: v for k, v in full.items()}
    losses = []
    for step in range(LLAMA_STEPS):
        leaves, p = _leaves(params)
        acc, ls = None, []
        for m in range(LLAMA_M):
            x, t = llama_data(step, m)
            loss, _ = llama.loss_fn(p, {"inputs": torch.from_numpy(x),
                                        "targets": torch.from_numpy(t)}, LLAMA_CFG)
            g = torch.autograd.grad(loss, leaves)
            acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
            ls.append(float(loss.detach()))
        with torch.no_grad():
            params = tree_unflatten(params, [
                (x - LLAMA_LR * (g * (1.0 / LLAMA_M))).detach()
                for x, g in zip(tree_leaves(params), acc)])
        losses.append(sum(ls) / len(ls))
    return losses, params


def _jax_step1_grads(np_full):
    cfg = jl.LlamaConfig.tiny(n_layers=4)
    grad = jax.jit(jax.grad(lambda p, b: jl.loss_fn(p, b, cfg)[0]))
    total = None
    for m in range(LLAMA_M):
        x, t = llama_data(0, m)
        g = grad(np_full, {"inputs": jnp.asarray(x), "targets": jnp.asarray(t)})
        total = g if total is None else jax.tree_util.tree_map(jnp.add, total, g)
    return jax.tree_util.tree_map(np.asarray, total)


def test_two_stage_llama_matches_one_device_and_jax():
    np_full = _jax_llama_params()
    full = llama.from_jax_params(np_full, LLAMA_CFG, "cpu", master=True)
    trees = _stage_trees(full)
    log = []
    res = MpmdPipeline(
        [StageSpec(1, lambda cfg: trees[0], stage0_forward,
                   _recording(stage0_backward, log, 0)),
         StageSpec(1, lambda cfg: trees[1], stage1_forward,
                   _recording(stage1_backward, log, 1), stage1_loss)],
        data_fn=llama_data, num_steps=LLAMA_STEPS, microbatches=LLAMA_M,
        lr=LLAMA_LR, return_params=True).fit()
    assert res.heals == 0 and res.steps_completed == LLAMA_STEPS

    want_losses, want = _one_device(full)
    np.testing.assert_allclose(res.losses, want_losses, rtol=1e-5)
    for stage, got in enumerate(res.final_params):
        for path, a, b in zip(tree_paths(got), tree_leaves(got),
                              tree_leaves(_stage_trees(want)[stage])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       err_msg=path)

    # step 1's gradients, summed over its microbatches (the first 2·M
    # backward calls), against JAX's on the same params
    jax_grads = _jax_step1_grads(np_full)
    j_trees = _stage_trees(jax_grads)
    for stage in (0, 1):
        calls = [g for s, g in log[:2 * LLAMA_M] if s == stage]
        assert len(calls) == LLAMA_M
        for path, w in zip(tree_paths(j_trees[stage]), tree_leaves(j_trees[stage])):
            got = sum(c[path] for c in calls)
            np.testing.assert_allclose(got, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"stage {stage} {path}")
