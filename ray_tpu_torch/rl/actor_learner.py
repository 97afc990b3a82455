"""Podracer-style actor–learner loop, in PyTorch: RLHF-shaped
post-training that runs the serving pool and the trainer as ONE system
(arXiv:2104.06272).

Mirrors ray_tpu/rl/actor_learner.py. Dataflow:

    rollout actors ──submit_stream(sampled)──> serve LLMPool replicas
         │  tokens + per-token behaviour logprobs (streamed)
         ▼
    runtime.put(trajectory) ── ref ──> ExperienceBuffer
         │                             (versioned, FIFO claims)
         ▼
    learner gang (train.Trainer backend="dcn", in-place elastic):
       claim shard -> V-trace/PPO-clip policy gradient through
       llama.forward (the flash forward and its fused backward)
       -> dcn_allreduce_grads -> SGD step -> checkpoint
         │ rank 0: runtime.put(new weights): ONE put
         ▼
    the loop's on_report -> LLMPool.publish_weights(ref, version)
       -> every replica adopts at its next chunk boundary, the buffer
          evicts stale experience

What differs from JAX, by design:

- The runtime calls (the buffer's spawn and calls, trajectory and
  weight puts) go through an injected runtime (``serve.runtime``'s
  interface, in-process by default), which ``ActorLearnerLoop`` also
  gives the pool and passes to the learner loop in its config, as JAX
  passes the buffer handle. The learner gang is the port's
  ``train.Trainer`` (JAX's ``JaxTrainer``) on its own runtime.
- The learners hold f32 masters, as JAX's do, drawn as the pool's
  ``build_model`` draws its weights (the same generator and seed: the
  pool's bf16 weights at 1B are the masters' bf16 casts). Rank 0
  publishes the serving form (matmul weights and embedding in the
  compute dtype, norms f32), which the replicas adopt as they hold it;
  JAX publishes the f32 tree and its replicas cast per use, which gives
  the same products.
- ``worker_specs`` are armed by :meth:`ActorLearnerLoop.run` before the
  gang starts: the in-process learners are threads of this process and
  share its fault specs (``train.fault_injection``).
- Each report carries ``timing_s``: the learner step's wait for its
  claim, forward+backward, gradient sync, update, checkpoint and publish
  put, in seconds (the forward+backward and update waited for on the
  learner's stream), the trained ``tokens`` and the mean and largest
  |target - behaviour| logprob over them (``logp_gap_*``); ``run()``
  also returns each weight version's rollout span and tokens
  (``rollout_by_version``) and each publish's timing.
"""

from __future__ import annotations

import collections
import logging
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.experience import ExperienceBuffer
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.train import fault_injection as _fi

logger = logging.getLogger(__name__)

# the vocabulary of build_model's default, which the pool's replicas use
VOCAB_SIZE = 32128


def default_reward(prompt: np.ndarray, tokens: list,
                   vocab_size: int = 256) -> np.ndarray:
    """Synthetic dense reward: 1 for every generated token in the low
    half of the vocab. Trivially improvable by a tiny policy, which is
    exactly what an end-to-end harness wants to measure."""
    t = np.asarray(tokens, np.int64)
    return (t < vocab_size // 2).astype(np.float32)


@dataclass
class ActorLearnerConfig:
    # model (must mirror the pool's build_model config so the frozen
    # init and the learner's params are the same network)
    model_size: str = "tiny"
    max_len: int = 96
    model_seed: int = 0
    # rollout
    n_rollout_actors: int = 1
    prompt_len: int = 8          # prompts are padded/bucketed to this
    max_new: int = 8
    temperature: float = 1.0
    top_p: float = 1.0
    base_seed: int = 0
    reward_fn: Callable | None = None  # (prompt, tokens) -> [T] rewards
    # learner
    iterations: int = 8
    trajectories_per_iter: int = 8
    num_learners: int = 1
    min_learners: int | None = None
    # JAX's ScalingConfig placement knobs, kept for the config's shape;
    # the port places its learners by the loop's ``device`` and refuses
    # any other value than None
    learner_platform: str | None = None
    learner_devices: int | None = None
    lr: float = 4.0  # per-TOKEN step: grads are summed then divided by
    # the GLOBAL token count (world-split-invariant mean)
    gamma: float = 0.9
    rho_bar: float = 1.0
    c_bar: float = 1.0
    clip_eps: float = 0.3
    entropy_coeff: float = 0.01
    publish_every: int = 1
    max_version_lag: int | None = 4
    claim_timeout_s: float = 180.0
    # sync_mode: rollouts produce EXACTLY trajectories_per_iter per
    # weight version and then wait for the next publish: on-policy
    # lockstep (Podracer's synchronous Sebulba flavor). With one rollout
    # actor the whole loop is bit-deterministic under fixed seeds: no
    # stream ever spans a weight swap, so trajectory content cannot
    # depend on publish timing. Async (default) overlaps generation
    # with learning and leans on the V-trace correction instead.
    sync_mode: bool = False
    # failure budgets (forwarded to RunConfig)
    max_failures: int = 1
    max_inplace_resumes: int = 8
    storage_path: str | None = None
    # chaos: fault specs armed for the learners (by run(), before the
    # gang starts) and the loop's rollout threads (site rl.rollout)
    worker_specs: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# learner side (runs inside each train worker)
# ---------------------------------------------------------------------------


def _stack_batch(trajs: list[dict], prompt_pad: int, max_new: int):
    """Left-aligned [prompt | gen | pad] rows: generation must sit
    directly after the true prompt (causal attention over a contiguous
    prefix), padding only at the tail."""
    b = len(trajs)
    seq_len = prompt_pad + max_new
    out = {
        "tokens": np.zeros((b, seq_len), np.int32),
        "prompt_len": np.zeros((b,), np.int32),
        "gen_tokens": np.zeros((b, max_new), np.int32),
        "behavior_logp": np.zeros((b, max_new), np.float32),
        "rewards": np.zeros((b, max_new), np.float32),
        "mask": np.zeros((b, max_new), np.float32),
        "dones": np.ones((b, max_new), np.float32),
    }
    for i, t in enumerate(trajs):
        p = np.asarray(t["prompt"], np.int32)
        g = np.asarray(t["tokens"], np.int32)[:max_new]
        n, m = len(p), len(g)
        if n > prompt_pad:
            raise ValueError(f"prompt {n} > prompt_pad {prompt_pad}")
        out["tokens"][i, :n] = p
        out["tokens"][i, n:n + m] = g
        out["prompt_len"][i] = n
        out["gen_tokens"][i, :m] = g
        out["behavior_logp"][i, :m] = np.asarray(
            t["logprobs"], np.float32)[:m]
        out["rewards"][i, :m] = np.asarray(t["rewards"], np.float32)[:m]
        out["mask"][i, :m] = 1.0
        out["dones"][i, :m] = 0.0
        if m:
            out["dones"][i, m - 1] = 1.0
    return out


def _pg_loss(params, batch, baseline, cfg, gamma, rho_bar, c_bar,
             clip_eps, temperature, entropy_coeff):
    """V-trace-corrected clipped policy gradient, SUMMED over the batch
    (the caller divides by the GLOBAL token count after the gradient
    allreduce, so any world-size split of the same trajectory set
    yields the same update). ``batch``: ``_stack_batch``'s columns as
    tensors on the params' device (ints int64).

    Behaviour logprobs came from the serving engine (the temperature/
    top-p distribution that actually sampled the tokens, possibly a
    version or more behind); targets are the same transformation under
    current weights: their ratio is the off-policy correction keyed on
    weight version that V-trace clips at rho_bar/c_bar."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.vtrace import vtrace

    logits = llama.forward(params, batch["tokens"], cfg).to(torch.float32)
    t_new = batch["gen_tokens"].shape[1]
    # gen token t is predicted from sequence position prompt_len-1+t
    pos = (batch["prompt_len"][:, None] - 1
           + torch.arange(t_new, device=logits.device)[None, :])
    tok_logits = logits.gather(
        1, pos[:, :, None].expand(-1, -1, logits.shape[-1]))  # [B, T, V]
    logp_all = torch.log_softmax(tok_logits / max(temperature, 1e-6), dim=-1)
    tgt_logp = logp_all.gather(2, batch["gen_tokens"][:, :, None])[..., 0]
    mask = batch["mask"]
    beh = batch["behavior_logp"]
    rewards = (batch["rewards"] - baseline) * mask
    values = torch.zeros_like(rewards)
    n_traj = rewards.shape[0]
    _, adv = vtrace(
        beh.T, tgt_logp.T, rewards.T, values.T,
        torch.zeros((n_traj,), dtype=torch.float32, device=rewards.device),
        batch["dones"].T, gamma=gamma, rho_bar=rho_bar, c_bar=c_bar)
    adv = adv.T  # [B, T], outside autograd (vtrace's stop-gradient)
    ratio = torch.exp(tgt_logp - beh)
    surr = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
    ent = -(torch.exp(logp_all) * logp_all).sum(-1)
    loss = -(surr * mask).sum() - entropy_coeff * (ent * mask).sum()
    n_mask = torch.clamp(mask.sum(), min=1.0)
    gap = (tgt_logp - beh).abs() * mask  # |target - behaviour| logprob
    aux = {"entropy": (ent * mask).sum() / n_mask,
           "mean_ratio": (ratio * mask).sum() / n_mask,
           "logp_gap_mean": gap.sum() / n_mask, "logp_gap_max": gap.max()}
    return loss, aux


def _serving_tree(tree, dtype: torch.dtype, name: str = ""):
    """The params as the pool serves them, on the host: norms f32, every
    other leaf in the compute dtype (``llama.init_params``' serving
    form)."""
    if isinstance(tree, dict):
        return {k: _serving_tree(v, dtype, k) for k, v in tree.items()}
    return tree.detach().to(
        torch.float32 if name.endswith("norm") else dtype).cpu()


def _resolve_traj(rt, t):
    """A claimed entry's trajectory: the runtime's ref resolved (the
    in-process runtime's put is the tree itself)."""
    if isinstance(t, dict) and "ref" in t:
        ref = t["ref"]
        return rt.get(ref, timeout=120) if rt.is_ref(ref) else ref
    return t


def _learner_loop(config: dict):
    """The per-worker gang loop (runs under ``train.Trainer`` backend
    "dcn").

    Sharding over a STREAM: each rank claims a disjoint FIFO shard of the
    experience queue per iteration, tagged (iteration, incarnation) so
    the buffer's rollback keeps delivery exact across in-place
    resumes."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.learner import batch_to, value_and_grad
    from ray_tpu_torch.serve.llm import model_config
    from ray_tpu_torch.train import dcn_allreduce_grads, session
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.utils.trees import tree_map

    hp = config["hp"]
    rt, buffer = config["runtime"], config["buffer"]
    dev = resolve_device(config["device"])
    rank = session.get_world_rank()
    world = session.get_world_size()
    group = session.get_collective_group()
    seq = session.get_resume_seq()

    cfg = model_config(hp["model_size"], max_len=hp["max_len"],
                       vocab_size=VOCAB_SIZE)
    start_it = 0
    ck = session.get_checkpoint()
    if ck is not None:
        d = ck.to_dict()
        params = tree_map(lambda a: torch.from_numpy(a).to(dev), d["params"])
        start_it = int(d["iteration"])
    else:
        # identical init to the pool's frozen weights: build_model's
        # generator and seed, kept as f32 masters
        gen = torch.Generator(device=dev).manual_seed(int(hp["model_seed"]))
        params = llama.init_params(cfg, gen, device=dev, master=True)
    if rank == 0:
        # exactness sweep: re-open claims whose update died after the
        # restored checkpoint; finalize ones the checkpoint contains
        rt.get(rt.call(buffer, "rollback", start_it, seq), timeout=60)
    if dev.type == "cuda":
        wait_stream = torch.cuda.current_stream(dev).synchronize
    else:
        def wait_stream():
            pass

    loss_kw = dict(cfg=cfg, gamma=hp["gamma"], rho_bar=hp["rho_bar"],
                   c_bar=hp["c_bar"], clip_eps=hp["clip_eps"],
                   temperature=hp["temperature"],
                   entropy_coeff=hp["entropy_coeff"])
    n_total = int(hp["trajectories_per_iter"])
    for it in range(start_it, int(hp["iterations"])):
        version = it + 1
        want = n_total // world + (1 if rank < n_total % world else 0)
        entries: list[dict] = []
        t_claim = time.perf_counter()
        deadline = time.monotonic() + float(hp["claim_timeout_s"])
        while len(entries) < want:
            out = rt.get(rt.call(buffer, "claim", f"rank{rank}",
                                 want - len(entries), version, seq),
                         timeout=60)
            entries.extend(out["entries"])
            if len(entries) >= want:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"rank {rank} starved: {len(entries)}/{want} "
                    f"trajectories after {hp['claim_timeout_s']}s "
                    f"(iteration {version})")
            time.sleep(0.02)
        trajs = [_resolve_traj(rt, e["traj"]) for e in entries]
        batch = _stack_batch(
            [t for t in trajs if len(t["tokens"])],
            int(hp["prompt_len"]), int(hp["max_new"]))

        # global reward stats FIRST: the baseline must be identical on
        # every rank or the summed gradients are not world-invariant
        local = np.asarray(
            [float(batch["rewards"].sum()), float(batch["mask"].sum()),
             float(len(trajs))], np.float64)
        tot = dcn_allreduce_grads({"s": local}, group, op="sum",
                                  timeout=60.0)["s"]
        baseline = float(tot[0] / max(tot[1], 1.0))
        mean_reward = baseline

        t0 = time.perf_counter()
        (loss, aux), grads = value_and_grad(
            _pg_loss, params, batch_to(batch, batch, dev), baseline,
            **loss_kw)
        wait_stream()
        t1 = time.perf_counter()
        host_grads = dcn_allreduce_grads(grads, group, op="sum",
                                         timeout=60.0)
        t2 = time.perf_counter()
        # per-token mean step: invariant to how trajectories split
        # across ranks AND to trajectory length mix
        scale = hp["lr"] / max(float(tot[1]), 1.0)
        with torch.no_grad():
            params = tree_map(lambda p, g: p - scale * g, params, host_grads)
        del grads, host_grads
        wait_stream()
        t3 = time.perf_counter()

        loss_tot = dcn_allreduce_grads(
            {"l": np.asarray([float(loss)], np.float64)}, group,
            op="sum", timeout=60.0)["l"][0]
        metrics = {
            "iteration": version, "version": version,
            "mean_reward": mean_reward,
            "loss": float(loss_tot) / max(float(tot[1]), 1.0),
            "entropy": float(aux["entropy"]),
            "mean_ratio": float(aux["mean_ratio"]),
            "logp_gap_mean": float(aux["logp_gap_mean"]),
            "logp_gap_max": float(aux["logp_gap_max"]),
            "tokens": float(tot[1]),
            "claimed": len(entries), "world": world,
        }
        ckpt = None
        t4 = t5 = time.perf_counter()
        if rank == 0:
            host = tree_map(lambda a: a.detach().cpu().numpy(), params)
            ckpt = Checkpoint.from_dict(
                {"params": host, "iteration": version},
                os.path.join(config["ck_dir"], f"ck_s{seq}_{version}"))
            del host
            t4 = time.perf_counter()
            if version % int(hp["publish_every"]) == 0 \
                    or version == int(hp["iterations"]):
                wref = rt.put(_serving_tree(params, cfg.compute_dtype))
                # rank 0 keeps its recently-published trees referenced
                # until the loop has adopted them (a runtime that frees
                # unreferenced puts must not free one mid-handoff)
                config["published"].append(wref)
                metrics["weights_ref"] = {"ref": wref}
                metrics["publish_t"] = time.monotonic()
            t5 = time.perf_counter()
        metrics["timing_s"] = {"claim": t0 - t_claim,
                               "forward_backward": t1 - t0,
                               "allreduce": t2 - t1, "update": t3 - t2,
                               "checkpoint": t4 - t3, "publish_put": t5 - t4}
        session.report(metrics, checkpoint=ckpt)


# ---------------------------------------------------------------------------
# the loop's side: rollout threads, publishing, lifecycle
# ---------------------------------------------------------------------------


class ActorLearnerLoop:
    """Drive rollouts on a serving pool and a learner gang as one closed
    post-training loop. The pool may be shared with live traffic:
    rollout streams are ordinary sampled requests.

    ``runtime`` (``serve.runtime``'s interface; None: in-process) spawns
    the buffer and carries the puts, and is the pool's runtime when the
    loop builds the pool; the learner gang runs on the trainer's
    in-process runtime; ``device`` is where the pool and the learners
    run (None: ``cuda``, which raises without a card)."""

    BACKPRESSURE_FACTOR = 2  # buffer high-water: N x one iteration,
    # bounds how stale (in versions) queued experience can grow when
    # rollouts outpace the learner; vtrace clips what remains
    # free consumed trajectories this many iterations behind the newest
    # checkpoint: deep enough that a corrupt-checkpoint fallback
    # (checkpoint_num_to_keep=2) never rolls back past freed claims
    FINALIZE_LAG = 4

    def __init__(self, config: ActorLearnerConfig, *,
                 pool=None, pool_kwargs: dict | None = None,
                 runtime=None, device=None):
        from ray_tpu_torch.serve.llm_pool import LLMPool

        for knob in ("learner_platform", "learner_devices"):
            if getattr(config, knob) is not None:
                raise ValueError(
                    f"ActorLearnerConfig.{knob} must be None: the port "
                    "places its learners by the loop's `device`")
        self.cfg = config
        self.device = resolve_device(device)
        self.runtime = runtime or InProcessRuntime()
        # the weight trees rank 0 published, until shutdown (at most 8)
        self._published: collections.deque = collections.deque(maxlen=8)
        self._own_pool = pool is None
        if pool is None:
            kw = dict(model_size=config.model_size,
                      max_len=config.max_len, seed=config.model_seed,
                      prompt_buckets=(config.prompt_len,),
                      autoscale=False, device=self.device,
                      runtime=self.runtime)
            kw.update(pool_kwargs or {})
            pool = LLMPool(**kw)
        self.pool = pool
        rt = self.runtime
        self.buffer = rt.spawn(
            ExperienceBuffer, {"max_version_lag": config.max_version_lag},
            name="experience-buffer")
        rt.get(rt.call(self.buffer, "size"), timeout=120)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._rollout_stats = {
            "trajectories": 0, "tokens": 0, "truncated": 0,
            "errors": 0, "dup_rejected": 0}
        self._rollout_lock = threading.Lock()
        self._publishes: list[tuple[int, float]] = []
        self._adoption_lat: list[float] = []
        # per publish: {"version", "publish_s", "adoption_s"}
        self._publish_timing: list[dict] = []
        # generating version -> {"first_submit", "last_add", "tokens"}
        self._rollout_by_version: dict[int, dict] = {}
        # last version every replica has ACTUALLY swapped in (not just
        # staged): the sync-mode rollout gate; generating against the
        # publish version alone could start a stream under old weights
        self._adopted_version = 0

    # ---- rollout actors (threads driving the pool's streaming API) ----

    def _make_prompt(self, rng: np.random.RandomState) -> list[int]:
        n = self.cfg.prompt_len
        return [int(x) for x in rng.randint(1, 250, n)]

    def _rollout_loop(self, idx: int):
        cfg = self.cfg
        rt = self.runtime
        reward_fn = cfg.reward_fn or default_reward
        rng = np.random.RandomState(cfg.base_seed * 9176 + 77 * idx + 1)
        high_water = self.BACKPRESSURE_FACTOR * cfg.trajectories_per_iter
        # sync mode: this actor's per-version quota (actors split the
        # iteration batch; remainder to the low indices)
        quota = (cfg.trajectories_per_iter // cfg.n_rollout_actors
                 + (1 if idx < cfg.trajectories_per_iter
                    % cfg.n_rollout_actors else 0))
        my_version = 0
        produced = 0
        local_seq = 0
        while not self._stop.is_set():
            try:
                if cfg.sync_mode:
                    cur_v = self._adopted_version
                    if cur_v > my_version:
                        my_version, produced = cur_v, 0
                    if produced >= quota:
                        time.sleep(0.002)  # wait for the next publish
                        continue
                elif rt.get(rt.call(self.buffer, "size"),
                            timeout=60) >= high_water:
                    time.sleep(0.05)
                    continue
                prompt = self._make_prompt(rng)
                seed = int(rng.randint(0, 2 ** 31 - 1))
                sub = self.pool.submit_stream({
                    "prompt_ids": prompt, "max_tokens": cfg.max_new,
                    "temperature": cfg.temperature, "top_p": cfg.top_p,
                    "seed": seed})
                t_sub = time.monotonic()
                toks: list[int] = []
                lps: list[float] = []
                version = sub.get("weights_version", 0)
                truncated = False
                while not self._stop.is_set():
                    out = self.pool.poll_stream(sub["rid"])
                    toks.extend(out["tokens"])
                    lps.extend(out.get("logprobs", []))
                    version = out.get("weights_version", version)
                    if out.get("done"):
                        truncated = bool(out.get("truncated"))
                        break
                    time.sleep(0.004)
                if not toks:
                    continue
                # chaos site: a rollout actor crashing/stalling between
                # generation and the buffer add ("drop" loses the
                # trajectory BEFORE accounting: a never-born rollout)
                if _fi.fire("rl.rollout", actor=idx) == "drop":
                    continue
                local_seq += 1
                traj = {
                    "prompt": np.asarray(prompt, np.int32),
                    "tokens": np.asarray(toks, np.int32),
                    "logprobs": np.asarray(lps, np.float32),
                    "rewards": np.asarray(
                        reward_fn(np.asarray(prompt, np.int32), toks),
                        np.float32),
                    "version": int(version), "seed": seed,
                }
                # the ref travels a SIDE CHANNEL (buffer -> learner
                # claim); the buffer never touches the payload
                ref = rt.put(traj)
                added = rt.get(rt.call(self.buffer, "add", {
                    "key": (idx, local_seq), "version": int(version),
                    "traj": {"ref": ref}}), timeout=60)
                produced += 1
                with self._rollout_lock:
                    span = self._rollout_by_version.setdefault(
                        int(version), {"first_submit": t_sub, "tokens": 0})
                    span["first_submit"] = min(span["first_submit"], t_sub)
                    span["last_add"] = time.monotonic()
                    span["tokens"] += len(toks)
                    st = self._rollout_stats
                    st["trajectories"] += 1
                    st["tokens"] += len(toks)
                    st["truncated"] += int(truncated)
                    st["dup_rejected"] += int(not added["accepted"])
            except Exception:  # noqa: BLE001 — the pool may be mid-
                # failover or draining; a rollout actor retries forever
                logger.debug("rollout actor %d retrying", idx,
                             exc_info=True)
                with self._rollout_lock:
                    self._rollout_stats["errors"] += 1
                time.sleep(0.1)

    # ---- weight publishing (via the trainer's report stream) --

    def _on_report(self, metrics: dict):
        wr = metrics.pop("weights_ref", None)
        if wr is None:
            return
        rt = self.runtime
        t0 = time.monotonic()
        try:
            v = self.pool.publish_weights(
                wr["ref"], version=int(metrics["version"]))
            t_pub = time.monotonic()
            rt.get(rt.call(self.buffer, "set_version", v), timeout=60)
            # unpin trajectories whose update is durably checkpointed
            # beyond any resume fallback (bounds buffer + store growth)
            rt.call(self.buffer, "finalize_through", v - self.FINALIZE_LAG)
            adopted = self.pool.wait_version(v, timeout=60.0)
            if adopted:
                self._adoption_lat.append(time.monotonic() - t0)
            self._publish_timing.append({
                "version": v, "publish_s": t_pub - t0,
                "adoption_s": time.monotonic() - t0 if adopted else None})
            # bump even on a wait timeout (a dying replica must not
            # deadlock the sync-mode rollout gate)
            self._adopted_version = v
            self._publishes.append((v, time.monotonic()))
        except Exception:  # noqa: BLE001 — a failed publish leaves
            # replicas on the previous version; the next one catches up
            logger.exception("weight publish for version %s failed",
                             metrics.get("version"))

    # ---- lifecycle ----

    def run(self) -> dict:
        """Blocking: rollouts + learner gang to completion. Returns the
        training summary (reward curve, resume/publish accounting,
        buffer conservation stats)."""
        from ray_tpu_torch.train import RunConfig, ScalingConfig, Trainer

        cfg = self.cfg
        rt = self.runtime
        storage = cfg.storage_path or tempfile.mkdtemp(
            prefix="ray_tpu_torch_actor_learner_")
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._rollout_loop, args=(i,),
                             daemon=True, name=f"rollout-{i}")
            for i in range(cfg.n_rollout_actors)
        ]
        for t in self._threads:
            t.start()
        hp = {
            "model_size": cfg.model_size, "max_len": cfg.max_len,
            "model_seed": cfg.model_seed,
            "prompt_len": cfg.prompt_len, "max_new": cfg.max_new,
            "temperature": cfg.temperature,
            "iterations": cfg.iterations,
            "trajectories_per_iter": cfg.trajectories_per_iter,
            "lr": cfg.lr, "gamma": cfg.gamma, "rho_bar": cfg.rho_bar,
            "c_bar": cfg.c_bar, "clip_eps": cfg.clip_eps,
            "entropy_coeff": cfg.entropy_coeff,
            "publish_every": cfg.publish_every,
            "claim_timeout_s": cfg.claim_timeout_s,
        }
        if cfg.worker_specs:
            _fi.configure(cfg.worker_specs)
        trainer = Trainer(
            _learner_loop,
            train_loop_config={
                "hp": hp, "buffer": self.buffer, "runtime": rt,
                "published": self._published,
                "device": str(self.device),
                "ck_dir": os.path.join(storage, "learner_ckpts"),
            },
            scaling_config=ScalingConfig(
                num_workers=cfg.num_learners,
                resources_per_worker={"CPU": 1}, backend="dcn",
                min_workers=cfg.min_learners, placement_strategy="PACK"),
            run_config=RunConfig(
                name="actor_learner", storage_path=storage,
                max_failures=cfg.max_failures,
                max_inplace_resumes=cfg.max_inplace_resumes,
                on_report=self._on_report),
        )
        try:
            result = trainer.fit()
        finally:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=30)
            if cfg.worker_specs:
                _fi.clear()
        buffer_stats = rt.get(rt.call(self.buffer, "stats"), timeout=60)
        rewards = [m["mean_reward"] for m in result.metrics_history
                   if "mean_reward" in m]
        with self._rollout_lock:
            rollout_stats = dict(self._rollout_stats)
            by_version = {v: {"seconds": d["last_add"] - d["first_submit"],
                              "tokens": d["tokens"]}
                          for v, d in sorted(self._rollout_by_version.items())}
        return {
            "result": result,
            "rewards": rewards,
            "error": result.error,
            "resumes": result.resumes,
            "buffer": buffer_stats,
            "rollouts": rollout_stats,
            "publishes": len(self._publishes),
            "final_version": (self._publishes[-1][0]
                              if self._publishes else 0),
            "adoption_latency_s": (
                float(np.mean(self._adoption_lat))
                if self._adoption_lat else None),
            "publish_timing": list(self._publish_timing),
            "rollout_by_version": by_version,
        }

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self._published.clear()
        try:
            self.runtime.kill(self.buffer)
        except Exception:  # noqa: BLE001
            pass
        if self._own_pool:
            try:
                self.pool.shutdown()
            except Exception:  # noqa: BLE001
                pass
