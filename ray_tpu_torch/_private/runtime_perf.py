"""The runtime benchmark families that run the port's model code.

Mirrors the families of ray_tpu/_private/runtime_perf.py whose workloads
run model code (the JAX module's ``LLMPool``, ``build_model``,
``ExperienceBuffer`` and ``MpmdPipeline``), with the same workloads,
record names and record fields:

- ``transfer``: its consumer tier only, weight publish-to-adoption over
  2 replicas and the 1-token KV handoff through one prefill worker;
- ``serve``: pool decode tokens/s at 1 and 2 replicas, and with the
  prefix cache;
- ``serve_spec``: speculation off, depth 2 and depth 4, greedy and
  sampled, each run held token for token to the spec-off run;
- ``rl``: sampled streaming rollout, the experience handoff through a
  buffer, and weight publish-to-adoption;
- ``pipeline``: a 2-stage 1F1B MPMD pipeline of 256x256 numpy stages.

The JAX module's other families (collective, the transfer family's store
and cross-node tiers, qos, colocate, obs, the core microbenchmarks)
measure ray_tpu's own runtime and run no model code: they are not here.

The serving families ride the tiny model with an EMULATED per-chunk
device dispatch latency (the engine's ``chunk_delay_s``): what they
measure is the serving tier (admission, routing, multi-replica overlap,
prefix reuse, speculation's pump count), not matmul speed.

Each family takes ``device`` (None: ``cuda``, which raises without a
card) and the runtime its members are spawned and called through: for
the serving families a ``serve/runtime.py`` runtime (None:
``InProcessRuntime``), for the pipeline a ``parallel/pipeline_runtime.py``
one (None: ``InProcessPipelineRuntime``). There is no cluster to start.

Run:  python -m ray_tpu_torch._private.runtime_perf [--family serve]
      [--quick] [--device cpu] [--out results.json]
Each result is one JSON line: {"name", "per_s", "unit", ...}.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.mpmd_pipeline import MpmdPipeline, StageSpec
from ray_tpu_torch.rl.experience import ExperienceBuffer
from ray_tpu_torch.serve.llm import build_model
from ray_tpu_torch.serve.llm_pool import LLMPool
from ray_tpu_torch.serve.runtime import InProcessRuntime
from ray_tpu_torch.utils.trees import tree_map, tree_size_bytes


def _emit(results: list, r: dict) -> None:
    results.append(r)
    print(json.dumps(r), flush=True)


def _host_weights(model_size: str, max_len: int, dev):
    """The tiny serving tree, seed 1, as host tensors: what a learner
    publishes."""
    params, _ = build_model(model_size, max_len=max_len, seed=1, device=dev)
    return tree_map(lambda a: a.detach().cpu(), params)


def _run_requests(n_requests: int, concurrency: int, one) -> float:
    """``one(i)`` for i < n_requests on threads, at most ``concurrency``
    at once; returns the wall seconds. A failed request raises here."""
    errs: list[str] = []
    sem = threading.Semaphore(concurrency)

    def guarded(i):
        with sem:
            try:
                one(i)
            except Exception as e:  # noqa: BLE001 — surface the real failure
                errs.append(f"req {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=guarded, args=(i,))
               for i in range(n_requests)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    if errs:
        raise RuntimeError(f"{len(errs)}/{n_requests} pool requests failed; "
                           f"first: {errs[0][:300]}")
    return dt


def run_transfer_benchmarks(*, quick: bool = False, device=None,
                            runtime=None) -> list[dict]:
    """The `transfer` family's consumer tier: the serve-side transfers.
    Weight publish-to-adoption over 2 replicas (one put of the host tree,
    every replica's engine swapped), and the prefill-to-decode KV handoff
    of a disaggregated 1-token generate (prompt over prefill_threshold:
    prefill on the worker, KV adoption on the decode replica, one decode
    chunk)."""
    dev = resolve_device(device)
    rt = runtime if runtime is not None else InProcessRuntime()
    results: list[dict] = []
    pool = LLMPool(model_size="tiny", slots=4, max_len=96, chunk_tokens=8,
                   prompt_buckets=(8, 16), min_replicas=2, max_replicas=2,
                   prefill_workers=1, prefill_threshold=12,
                   autoscale=False, device=dev, runtime=rt)
    try:
        host = _host_weights("tiny", 96, dev)
        lats = []
        for _ in range(2 if quick else 4):
            t0 = time.perf_counter()
            v = pool.publish_weights(host)
            assert pool.wait_version(v, timeout=60.0), "adoption timeout"
            lats.append(time.perf_counter() - t0)
        _emit(results, {
            "name": "transfer weight publish-to-adoption (2 replicas)",
            "per_s": round(1.0 / min(lats), 2), "unit": "ops/s",
            "latency_s": round(min(lats), 4),
            "weight_bytes": tree_size_bytes(host)})
        rng = np.random.RandomState(11)
        pool.generate([int(x) for x in rng.randint(1, 250, 14)], 1)  # warm
        lats = []
        for i in range(3 if quick else 6):
            p2 = [int(x) for x in np.random.RandomState(20 + i)
                  .randint(1, 250, 14)]
            t0 = time.perf_counter()
            pool.generate(p2, 1)
            lats.append(time.perf_counter() - t0)
        _emit(results, {
            "name": "transfer kv handoff (prefill to decode, 1 token)",
            "per_s": round(1.0 / min(lats), 2), "unit": "ops/s",
            "latency_s": round(min(lats), 4)})
    finally:
        pool.shutdown()
    return results


def run_serve_benchmarks(*, quick: bool = False, device=None,
                         runtime=None) -> list[dict]:
    """Serving-tier figures: LLMPool aggregate decode throughput at 1 vs
    2 replicas, plus the prefix-cache configuration, under the emulated
    0.05 s chunk dispatch (module docstring)."""
    dev = resolve_device(device)
    rt = runtime if runtime is not None else InProcessRuntime()
    prompt_len, new_tokens, chunk_delay = 16, 96, 0.05
    n_requests = 16 if quick else 32
    concurrency = 32
    results: list[dict] = []

    def prompt_for(i, shared_head):
        rng = np.random.RandomState(1000 + i)
        if shared_head is not None:
            return list(shared_head) + [int(x) for x in rng.randint(1, 250, 7)]
        return [int(x) for x in rng.randint(1, 250, prompt_len)]

    def run_pool(n_replicas, *, prefix=False):
        pool = LLMPool(
            model_size="tiny", slots=8, max_len=128, chunk_tokens=8,
            prompt_buckets=(prompt_len,), min_replicas=n_replicas,
            max_replicas=n_replicas, chunk_delay_s=chunk_delay,
            prefix_cache_block=8 if prefix else 0, autoscale=False,
            device=dev, runtime=rt)
        head = ([int(x) for x in np.random.RandomState(7).randint(1, 250, 8)]
                if prefix else None)
        try:
            # warm every replica through both prefill paths (cold batched
            # prefill, then the prefix-cache suffix path)
            warms = [prompt_for(0, head)] + ([prompt_for(1, head)]
                                             if prefix else [])
            for warm in warms:
                rt.get([rt.call(r.handle, "generate", warm, 8)
                        for r in pool._alive()], timeout=600)
            outs = [None] * n_requests

            def one(i):
                outs[i] = pool.generate(prompt_for(100 + i, head), new_tokens)

            dt = _run_requests(n_requests, concurrency, one)
            total = sum(len(o["tokens"]) for o in outs)
            ttfts = sorted(o["token_times_s"][0] - o["submitted_s"]
                           for o in outs)
            st = pool.stats()
            return {
                "per_s": round(total / dt, 1),
                "unit": "tokens/s",
                "replicas": n_replicas,
                "concurrency": concurrency,
                "n_requests": n_requests,
                "new_tokens": new_tokens,
                "chunk_delay_s": chunk_delay,
                "ttft_p50_s": round(ttfts[len(ttfts) // 2], 3),
                "ttft_p99_s": round(ttfts[min(len(ttfts) - 1,
                                              int(0.99 * len(ttfts)))], 3),
                "prefix_hit_rate": st["prefix_cache_hit_rate"],
            }
        finally:
            pool.shutdown()

    for name, kw in [
        ("serve pool decode (1 replica)", dict(n_replicas=1)),
        ("serve pool decode (2 replicas)", dict(n_replicas=2)),
        ("serve pool decode (2 replicas + prefix cache)",
         dict(n_replicas=2, prefix=True)),
    ]:
        _emit(results, {"name": name, **run_pool(**kw)})
    return results


def run_serve_spec_benchmarks(*, quick: bool = False, device=None,
                              runtime=None) -> list[dict]:
    """The `serve_spec` family: speculative decoding's pump-rate win.
    The serve family's workload with chunks of 4 tokens, speculation off
    and at draft depth 2 and 4 (a 1-layer draft), greedy and sampled.
    Each verify round emits 1..K+1 tokens, so a stream finishes in fewer
    chunk dispatches. Every spec record carries ``match_baseline``: its
    token sequences against the spec-off run of the same seeds."""
    dev = resolve_device(device)
    rt = runtime if runtime is not None else InProcessRuntime()
    prompt_len, new_tokens, chunk_delay = 16, 96, 0.05
    chunk_tokens = 4  # short pumps: dispatch cadence dominates
    n_requests = 16 if quick else 32
    concurrency = 32
    results: list[dict] = []

    def prompt_for(i):
        rng = np.random.RandomState(1000 + i)
        return [int(x) for x in rng.randint(1, 250, prompt_len)]

    def run_pool(spec_depth, temperature):
        pool = LLMPool(
            model_size="tiny", slots=8, max_len=128,
            chunk_tokens=chunk_tokens, prompt_buckets=(prompt_len,),
            min_replicas=1, max_replicas=1, chunk_delay_s=chunk_delay,
            spec_depth=spec_depth, spec_draft_layers=1, autoscale=False,
            device=dev, runtime=rt)
        try:
            pool.generate(prompt_for(0), 8, temperature=temperature, seed=1)
            outs = [None] * n_requests

            def one(i):
                outs[i] = pool.generate(prompt_for(100 + i), new_tokens,
                                        temperature=temperature,
                                        seed=(100 + i) * 7 + 1)

            dt = _run_requests(n_requests, concurrency, one)
            total = sum(len(o["tokens"]) for o in outs)
            st = pool.stats()
            spec_st = next(
                (s.get("spec") for s in st["per_replica"].values()
                 if isinstance(s, dict) and s.get("spec")), None)
            return {
                "per_s": round(total / dt, 1),
                "unit": "tokens/s",
                "replicas": 1,
                "concurrency": concurrency,
                "n_requests": n_requests,
                "new_tokens": new_tokens,
                "chunk_delay_s": chunk_delay,
                "chunk_tokens": chunk_tokens,
                "spec_depth": spec_depth,
                "temperature": temperature,
                "acceptance_rate": (spec_st or {}).get("acceptance_rate"),
            }, [o["tokens"] for o in outs]
        finally:
            pool.shutdown()

    for temperature, label in [(0.0, "greedy"), (0.8, "sampled")]:
        baseline = None
        for depth in (0, 2, 4):
            r, toks = run_pool(depth, temperature)
            if depth == 0:
                baseline = toks
            else:
                # the correctness contract on the bench workload itself:
                # speculation emits exactly the plain path's sequences
                r["match_baseline"] = toks == baseline
            tag = "off" if depth == 0 else f"depth {depth}"
            _emit(results, {"name": f"serve spec decode {tag} ({label})", **r})
    return results


def run_rl_benchmarks(*, quick: bool = False, device=None,
                      runtime=None) -> list[dict]:
    """The `rl` family: the actor-learner loop's three data paths.

    - rollout tokens/s: sampled streaming decode (temperature / top-p,
      per-token logprobs) through the pool's submit_stream / poll_stream;
    - experience handoff: a trajectory put through the runtime, added to
      a versioned ``ExperienceBuffer`` member, claimed and fetched back;
    - publish-to-adoption: one-put weight broadcast until every replica's
      engine has swapped the new version."""
    dev = resolve_device(device)
    rt = runtime if runtime is not None else InProcessRuntime()
    results: list[dict] = []
    prompt_len, new_tokens, chunk_delay = 16, 96, 0.05
    n_requests = 12 if quick else 24
    pool = LLMPool(
        model_size="tiny", slots=8, max_len=128, chunk_tokens=8,
        prompt_buckets=(prompt_len,), min_replicas=2, max_replicas=2,
        chunk_delay_s=chunk_delay, autoscale=False, device=dev, runtime=rt)
    try:
        def stream_one(i, out):
            rng = np.random.RandomState(2000 + i)
            prompt = [int(x) for x in rng.randint(1, 250, prompt_len)]
            sub = pool.submit_stream({
                "prompt_ids": prompt, "max_tokens": new_tokens,
                "temperature": 1.0, "top_p": 0.95, "seed": 1000 + i})
            toks, lps = [], []
            while True:
                r = pool.poll_stream(sub["rid"])
                toks += r["tokens"]
                lps += r["logprobs"]
                if r["done"]:
                    break
                time.sleep(0.004)
            assert len(toks) == len(lps)
            out[i] = len(toks)

        # warm both replicas: two concurrent streams, least-loaded routing
        # lands one on each
        warm = [0, 0]
        wts = [threading.Thread(target=stream_one, args=(i, warm))
               for i in range(2)]
        for t in wts:
            t.start()
        for t in wts:
            t.join()
        counts = [0] * n_requests
        threads = [threading.Thread(target=stream_one, args=(i, counts))
                   for i in range(n_requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        if sum(counts) != n_requests * new_tokens:
            raise RuntimeError(f"rollout streams gave {counts} tokens, want "
                               f"{new_tokens} each")
        _emit(results, {
            "name": "rl rollout sampled stream (2 replicas)",
            "per_s": round(sum(counts) / dt, 1), "unit": "tokens/s",
            "replicas": 2, "n_requests": n_requests,
            "new_tokens": new_tokens, "chunk_delay_s": chunk_delay})

        buf = rt.spawn(ExperienceBuffer, {})
        rt.get(rt.call(buf, "size"), timeout=120)
        traj_tokens = 4096  # a long-generation trajectory's arrays
        traj = {
            "prompt": np.arange(512, dtype=np.int32),
            "tokens": np.zeros(traj_tokens, np.int32),
            "logprobs": np.zeros(traj_tokens, np.float32),
            "rewards": np.zeros(traj_tokens, np.float32),
            "version": 0,
        }
        nbytes = sum(v.nbytes for v in traj.values()
                     if isinstance(v, np.ndarray))
        iters = 30 if quick else 100

        def xfer_once(i):
            ref = rt.put(traj)
            rt.get(rt.call(buf, "add", {"key": (0, i), "version": 0,
                                        "traj": {"ref": ref}}), timeout=60)
            out = rt.get(rt.call(buf, "claim", "bench", 1, i + 1), timeout=60)
            got = rt.get(out["entries"][0]["traj"]["ref"], timeout=60)
            for k, v in traj.items():
                if isinstance(v, np.ndarray) and (
                        got[k].dtype != v.dtype
                        or got[k].tobytes() != v.tobytes()):
                    raise RuntimeError(f"experience round trip changed {k!r}")

        xfer_once(-1)  # warm
        t0 = time.perf_counter()
        for i in range(iters):
            xfer_once(i)
        dt = time.perf_counter() - t0
        _emit(results, {
            "name": "rl experience handoff (put+add+claim+get)",
            "per_s": round(iters / dt, 1), "unit": "ops/s",
            "traj_bytes": nbytes,
            "mb_per_s": round(iters * nbytes / dt / 1e6, 1)})
        rt.kill(buf)

        host = _host_weights("tiny", 128, dev)
        lats = []
        for _ in range(3 if quick else 5):
            t0 = time.perf_counter()
            v = pool.publish_weights(host)
            assert pool.wait_version(v, timeout=60.0), "adoption timed out"
            lats.append(time.perf_counter() - t0)
        lat = min(lats)
        _emit(results, {
            "name": "rl weight publish-to-adoption (2 replicas)",
            "per_s": round(1.0 / lat, 1), "unit": "ops/s",
            "latency_s": round(lat, 4),
            "weight_bytes": tree_size_bytes(host)})
    finally:
        pool.shutdown()
    return results


# the pipeline family's stages: 256x256 matmuls in numpy, 8 microbatches
# of 256 rows, both stages drawn from seed 7
PIPE_BSZ, PIPE_DIM, PIPE_MICROBATCHES = 256, 256, 8


def _pipe_data(step, m):
    rng = np.random.RandomState(1000 + step * 100 + m)
    return (rng.standard_normal((PIPE_BSZ, PIPE_DIM)),
            rng.standard_normal((PIPE_BSZ, PIPE_DIM)))


def _pipe_init(cfg):
    return {"w": np.random.RandomState(7).standard_normal((PIPE_DIM,
                                                            PIPE_DIM))}


def _pipe_fwd(params, x):
    return x @ params["w"], x


def _pipe_bwd(params, x, dy):
    return dy @ params["w"].T, {"w": x.T @ dy}


def _pipe_loss(params, y, t):
    d = y - t
    return 0.5 * float(np.mean(d * d)), d / d.size


def _pipeline(steps: int, *, runtime=None, return_params: bool = False):
    """The family's 2-stage 1F1B pipeline (the runtime's default lr)."""
    return MpmdPipeline(
        [StageSpec(1, _pipe_init, _pipe_fwd, _pipe_bwd),
         StageSpec(1, _pipe_init, _pipe_fwd, _pipe_bwd, _pipe_loss)],
        data_fn=_pipe_data, num_steps=steps, microbatches=PIPE_MICROBATCHES,
        return_params=return_params, name="bench-pipe", runtime=runtime)


def run_pipeline_benchmarks(*, quick: bool = False, device=None,
                            runtime=None) -> list[dict]:
    """The `pipeline` family: a 2-stage MPMD pipeline, one worker a
    stage, 1F1B, activations and their gradients streamed between the
    stages over the runtime's p2p lanes, driven end to end through
    ``MpmdPipeline.fit`` (worker start included in the wall). Records
    optimizer steps/s, stage-boundary hops/s, and the measured bubble
    (p2p wait + allreduce wait over wall) beside the analytic
    (S-1)/(M+S-1). The stages are numpy on the host; ``device`` is
    resolved like every family's (None: ``cuda``), and on a card the
    in-process runtime gives each worker a CUDA stream of its own."""
    resolve_device(device)
    results: list[dict] = []
    steps = 4 if quick else 10
    mbs = PIPE_MICROBATCHES
    pipe = _pipeline(steps, runtime=runtime)
    start = time.perf_counter()
    res = pipe.fit()
    wall = time.perf_counter() - start
    assert res.steps_completed == steps, res
    assert res.heals == 0 and res.gang_restarts == 0, res
    num_stages = 2
    analytic = (num_stages - 1) / (mbs + num_stages - 1)
    _emit(results, {
        "name": "pipeline 2-stage 1f1b (steps/s)",
        "per_s": round(steps / wall, 3), "unit": "steps/s",
        "steps": steps, "microbatches": mbs,
        "bubble_measured": round(res.bubble_fraction, 4),
        "bubble_analytic": round(analytic, 4),
        "heals": res.heals, "gang_restarts": res.gang_restarts})
    # each microbatch makes one activation hop down and one gradient hop
    # up per stage boundary: 2 * mbs p2p round trips per step
    _emit(results, {
        "name": "pipeline stage-boundary hops (microbatches/s)",
        "per_s": round(2 * mbs * steps / wall, 1), "unit": "hops/s"})
    return results


RUNNERS = {
    "transfer": run_transfer_benchmarks,
    "serve": run_serve_benchmarks,
    "serve_spec": run_serve_spec_benchmarks,
    "rl": run_rl_benchmarks,
    "pipeline": run_pipeline_benchmarks,
}


def run_benchmarks(*, quick: bool = False, device=None,
                   runtime=None) -> list[dict]:
    """Every family here, in the JAX module's order: serve, serve_spec,
    rl, transfer, then the pipeline (on its in-process runtime;
    ``runtime`` is the serving families')."""
    results = []
    for fam in ("serve", "serve_spec", "rl", "transfer"):
        results.extend(RUNNERS[fam](quick=quick, device=device,
                                    runtime=runtime))
    results.extend(run_pipeline_benchmarks(quick=quick, device=device))
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--family", default="all", choices=("all", *RUNNERS),
                   help="run one workload family only")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.family == "all":
        results = run_benchmarks(quick=args.quick, device=args.device)
    else:
        results = RUNNERS[args.family](quick=args.quick, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "ts": time.strftime("%Y-%m-%d")},
                      f, indent=2)
    return results


if __name__ == "__main__":
    main()
