"""The port's actor-learner loop against ray_tpu.rl.actor_learner on the
CPU.

- ``_stack_batch`` equal, and ``_pg_loss``'s loss, aux and gradients at
  the tiny model in f32 from JAX's weights (rtol 1e-5, atol 1e-5 x the
  leaf's largest gradient);
- the off-by-one-version importance correction of
  tests/test_actor_learner.py, redone in the port: a trajectory sampled
  by the port's engine under v0 is exactly on-policy for v0's weights
  and corrected for v1's;
- the ExperienceBuffer's four scenarios of tests/test_actor_learner.py
  driven by one script on both copies, outputs equal;
- the in-process ActorLearnerLoop at tiny (sync mode, one rollout actor,
  one learner, 3 iterations): conservation and exact delivery, and the
  same run with the learner dying in iteration 2, resumed in place.
PPO with num_learners > 1 is tests/test_torch_rl_learner_group.py's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import actor_learner as j_al
from ray_tpu.rl.experience import ExperienceBuffer as JBuffer
from ray_tpu.serve import llm as j_llm
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.models.decode_engine import RaggedDecoder
from ray_tpu_torch.rl import actor_learner as t_al
from ray_tpu_torch.rl.experience import ExperienceBuffer as TBuffer
from ray_tpu_torch.rl.learner import batch_to, value_and_grad
from ray_tpu_torch.rl.vtrace import vtrace as t_vtrace
from ray_tpu_torch.serve import llm as t_llm
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths
from tests.test_actor_learner import _np_vtrace

LOSS_KW = dict(gamma=0.9, rho_bar=1.0, c_bar=1.0, clip_eps=0.3,
               temperature=1.0)


def _trajs(n, prompt_len, max_new, seed):
    """Ragged trajectories: prompts up to prompt_len, generations up to
    max_new (one empty), behaviour logprobs and rewards."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p, m = rng.randint(2, prompt_len + 1), (0 if i == 1 else
                                               rng.randint(1, max_new + 1))
        out.append({"prompt": rng.randint(1, 250, p).astype(np.int32),
                    "tokens": rng.randint(0, 256, m).astype(np.int32),
                    "logprobs": -rng.rand(m).astype(np.float32) * 3,
                    "rewards": rng.rand(m).astype(np.float32)})
    return out


def test_stack_batch_equal():
    trajs = _trajs(5, 8, 6, seed=0)
    want = j_al._stack_batch(trajs, 8, 6)
    got = t_al._stack_batch(trajs, 8, 6)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        t_al._stack_batch(trajs, 4, 6)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny serving model (f32) and its weights in the port."""
    params, cfg = j_llm.build_model("tiny", max_len=64, seed=0)
    host = jax.tree_util.tree_map(np.asarray, params)
    tcfg = t_llm.model_config("tiny", max_len=64, vocab_size=256)
    tparams = t_llama.from_jax_params(host, tcfg, device="cpu", master=True)
    return params, cfg, host, tparams, tcfg


@pytest.mark.parametrize("entropy_coeff", [0.0, 0.01])
def test_pg_loss_and_grads_match_jax(tiny, entropy_coeff):
    """Loss and aux at rtol 1e-5; every gradient leaf at rtol 1e-5 with
    atol 1e-5 x its largest entry (f32 sums over the vocab and the
    layers in another order)."""
    params, cfg, _, tparams, tcfg = tiny
    trajs = [t for t in _trajs(4, 8, 8, seed=1) if len(t["tokens"])]
    batch = j_al._stack_batch(trajs, 8, 8)
    baseline = float(batch["rewards"].sum() / batch["mask"].sum())
    (jloss, jaux), jgrads = jax.value_and_grad(functools.partial(
        j_al._pg_loss, cfg=cfg, entropy_coeff=entropy_coeff, **LOSS_KW),
        has_aux=True)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.float32(baseline))
    (tloss, taux), tgrads = value_and_grad(
        t_al._pg_loss, tparams, batch_to(batch, batch, "cpu"), baseline,
        cfg=tcfg, entropy_coeff=entropy_coeff, **LOSS_KW)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("entropy", "mean_ratio"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    assert tree_paths(tgrads) == tree_paths(want)
    for path, g, w in zip(tree_paths(want), tree_leaves(tgrads),
                          tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=path)


def test_off_by_one_version_importance_correction(tiny):
    """A trajectory sampled by the port's engine under v0 weights,
    corrected against v1 weights one publish later: the same version is
    exactly on-policy (|mean_ratio - 1| < 1e-4), one version later the
    ratios move off 1 (> 1e-3); and the port's V-trace matches the numpy
    transcription of the recursion with genuinely off ratios."""
    _, _, _, params0, cfg = tiny
    params1 = {k: ({kk: vv * 1.05 if vv.ndim >= 3 else vv
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else (v * 1.05 if v.ndim >= 2 else v))
               for k, v in params0.items()}
    eng = RaggedDecoder(params0, cfg, slots=2, max_len=64, chunk_tokens=4,
                        prompt_buckets=(8,), device="cpu")
    rng = np.random.RandomState(11)
    prompt = rng.randint(1, 250, 8).astype(np.int32)
    sid = eng.submit(prompt, 8, temperature=1.0, seed=21)
    eng.drain()
    s = eng.pop_finished(sid)
    traj = {"prompt": prompt, "tokens": np.asarray(s.tokens[:8], np.int32),
            "logprobs": np.asarray(s.logprobs[:8], np.float32),
            "rewards": rng.rand(8).astype(np.float32)}
    batch = batch_to(t_al._stack_batch([traj], 8, 8), t_al._stack_batch(
        [traj], 8, 8), "cpu")
    loss_fn = functools.partial(t_al._pg_loss, cfg=cfg, entropy_coeff=0.0,
                                **LOSS_KW)
    with torch.no_grad():
        _, aux_same = loss_fn(params0, batch, 0.0)
        _, aux_off = loss_fn(params1, batch, 0.0)
    assert abs(float(aux_same["mean_ratio"]) - 1.0) < 1e-4
    assert abs(float(aux_off["mean_ratio"]) - 1.0) > 1e-3

    beh = traj["logprobs"].astype(np.float64)
    tgt = beh + rng.uniform(-1.0, 0.5, 8)
    r = rng.standard_normal(8)
    vs_ref, adv_ref = _np_vtrace(beh, tgt, r, gamma=0.9)
    vs, adv = t_vtrace(beh, tgt, r, np.zeros(8), 0.0, np.zeros(8),
                       gamma=0.9, rho_bar=1.0, c_bar=1.0)
    np.testing.assert_allclose(vs.numpy(), vs_ref, rtol=1e-5)
    np.testing.assert_allclose(adv.numpy(), adv_ref, rtol=1e-5)


# ---------------- ExperienceBuffer: one script, both copies ----------------


def _mk(buffer, n, version=0, key0=0):
    return [buffer.add({"key": (0, key0 + i), "version": version,
                        "traj": {"n": key0 + i}})
            for i in range(n)]


def _fifo_dedup(cls):
    b = cls()
    out = [_mk(b, 5), b.add({"key": (0, 2), "version": 0, "traj": {}})]
    out += [b.claim("rank0", 2, iteration=1), b.claim("rank1", 2, iteration=1),
            b.claim("rank0", 5, iteration=2), b.claim("rank0", 1, iteration=2),
            b.stats()]
    return out


def _rollback(cls):
    b = cls()
    out = [_mk(b, 6),
           b.claim("rank0", 2, iteration=1, incarnation=0),
           b.claim("rank0", 2, iteration=2, incarnation=0),
           b.claim("rank1", 2, iteration=2, incarnation=1),
           b.rollback(restored_iteration=1, incarnation=1), b.stats(),
           b.claim("rank0", 4, iteration=2, incarnation=1), b.stats()]
    return out


def _finalize(cls):
    b = cls()
    out = [_mk(b, 6), b.claim("rank0", 2, iteration=1),
           b.claim("rank0", 2, iteration=5), b.finalize_through(3), b.stats(),
           b.finalize_through(3),
           b.rollback(restored_iteration=0, incarnation=1), b.stats()]
    return out


def _staleness(cls):
    b = cls(max_version_lag=1)
    out = [_mk(b, 3, version=0), _mk(b, 2, version=2, key0=10),
           b.set_version(2), b.size(),
           b.add({"key": (9, 9), "version": 0, "traj": {}}), b.stats(),
           b.version()]
    return out


@pytest.mark.parametrize("script", [_fifo_dedup, _rollback, _finalize,
                                    _staleness],
                         ids=lambda f: f.__name__.strip("_"))
def test_experience_buffer_equals_jax(script):
    got, want = script(TBuffer), script(JBuffer)
    assert got == want
    st = got[-1] if isinstance(got[-1], dict) else got[-2]
    # conservation and uniqueness, as the JAX tests hold them
    assert st["added"] == st["queued"] + st["consumed"] + st["dropped_stale"]
    assert len(set(st["consumed_seqs"])) == st["consumed"]


# ---------------- the loop, in process ----------------


def _assert_exact_delivery(st):
    assert st["added"] == st["queued"] + st["consumed"] \
        + st["dropped_stale"], st
    assert len(set(st["consumed_seqs"])) == st["consumed"], st


def _run_loop(**kw):
    base = dict(prompt_len=8, max_new=8, iterations=3,
                trajectories_per_iter=4, n_rollout_actors=1,
                num_learners=1, lr=4.0, publish_every=1, base_seed=1,
                sync_mode=True)
    base.update(kw)
    loop = t_al.ActorLearnerLoop(
        t_al.ActorLearnerConfig(**base),
        pool_kwargs=dict(slots=4, chunk_tokens=4, min_replicas=1,
                         max_replicas=1, autoscale=False),
        device="cpu")
    try:
        out = loop.run()
        out["published_held"] = len(loop._published)
    finally:
        loop.shutdown()
    out["published_after_shutdown"] = len(loop._published)
    return out


def test_loop_sync_conservation_and_exact_delivery():
    out = _run_loop()
    assert out["error"] is None, out["error"]
    assert out["resumes"] == {"inplace": 0, "gang": 0}
    assert len(out["rewards"]) == 3
    assert out["publishes"] == 3 and out["final_version"] == 3
    # the loop keeps rank 0's published trees until it shuts down
    assert out["published_held"] == 3 and out["published_after_shutdown"] == 0
    st = out["buffer"]
    _assert_exact_delivery(st)
    # sync mode: one iteration's worth a version, each consumed once (the
    # rollouts for version 3, made before the stop, stay queued)
    assert st["consumed"] == 12
    assert out["rollouts"]["trajectories"] == st["added"] \
        + st["rejected_stale"] + st["dups"]
    hist = out["result"].metrics_history
    # lag 0 in sync mode: the learner's targets are the engine's
    # behaviour logprobs (f32, the same weights)
    for m in hist:
        assert abs(m["mean_ratio"] - 1.0) < 1e-4, m
        assert m["logp_gap_max"] < 1e-4 and m["tokens"] == 4 * 8
        assert set(m["timing_s"]) == {"claim", "forward_backward",
                                      "allreduce", "update", "checkpoint",
                                      "publish_put"}
    assert [p["version"] for p in out["publish_timing"]] == [1, 2, 3]
    # versions 0-2 were each rolled out (one iteration's worth), and 3
    # was started before the stop
    assert list(out["rollout_by_version"])[:3] == [0, 1, 2]
    assert all(out["rollout_by_version"][v]["tokens"] == 32 for v in range(3))


def test_loop_learner_death_resumes_inplace():
    """The learner dies at iteration 2's gradient sync (three syncs an
    iteration: reward stats, gradients, loss); the trainer resumes it in
    place from iteration 1's checkpoint, the buffer re-opens iteration
    2's claim, and delivery stays exact."""
    out = _run_loop(max_failures=0, worker_specs=[{
        "site": "collective.allreduce", "action": "die", "after": 4,
        "count": 1}])
    assert out["error"] is None, out["error"]
    assert out["resumes"] == {"inplace": 1, "gang": 0}, out["resumes"]
    assert [m["version"] for m in out["result"].metrics_history] == [1, 2, 3]
    st = out["buffer"]
    _assert_exact_delivery(st)
    assert st["reopened"] == 4 and st["consumed"] == 12
    for m in out["result"].metrics_history:
        assert abs(m["mean_ratio"] - 1.0) < 1e-4, m


@pytest.mark.parametrize("knob,value", [("learner_platform", "cpu"),
                                        ("learner_devices", 2)])
def test_loop_refuses_jax_placement_knobs(knob, value):
    """The port places its learners by the loop's device: JAX's
    ScalingConfig knobs are refused, not ignored."""
    with pytest.raises(ValueError, match=knob):
        t_al.ActorLearnerLoop(t_al.ActorLearnerConfig(**{knob: value}),
                              device="cpu")
