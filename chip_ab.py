"""Times the port's flash-attention forward and backward kernels of one
checkout at the main-path shapes, on one NVIDIA GPU; or, with `engine`,
its greedy serving engine at Llama-1B; or, with `server`, where the
serving wrappers' time goes at Llama-1B; or, with `pool`, what the serving
pool's layer costs and what a second replica on one card buys; or, with
`moe`, the greedy engine on the 1B-MoE against the dense 1B.

    python3 chip_ab.py <checkout>
    python3 chip_ab.py <checkout> engine
    python3 chip_ab.py <checkout> server
    python3 chip_ab.py <checkout> pool
    python3 chip_ab.py <checkout> moe

To compare two versions on one card, unpack both (``git archive``) into
directories that ``.gitignore`` lists and time them in turns in one
machine session: parent, change, change, parent. The checkout's own
``chip_smoke.py`` gives the inputs and the timer, and its kernels are
built from its own sources into its own ``build/``. Prints one JSON line:
mean ms per call (CUDA events around eager calls through the wrappers)
and the launches by entry point, which show the kernels timed.

`engine` runs the checkout's `phase_serving` (32 requests of 128 prompt
and 128 new tokens on 8 slots, chunks of 32: every admission a full wave
of 8), then greedy traffic that admits partial waves: 32 requests of 128
prompt tokens with `max_new` staggered over 16, 32, ..., 128, so slots
free a few at a time. That traffic runs twice (the first pass meets each
prefill width for the first time); each pass prints its tokens/s, the
mean time of the pumps that admitted streams and of those that only
decoded (each pump ends in the engine's one device->host transfer), and
how many pumps admitted how many streams. Last, the admission itself:
`_prefill_batch_into_slots` of 1, 2, 4 or 8 streams at a width of as
many rows and at the slot width of 8 (rows past the streams go to an
out-of-range slot and are dropped), ms per call by CUDA events, and
the device launches (kernels and copies, by torch.profiler) of one such
call and of one greedy decode step of the 8-slot batch.

`server` serves `phase_serving`'s 32 greedy requests (128 new tokens, 8
slots, chunks of 32, one set of seeded weights) four ways, in turns
(A B C D D C B A), one line each with tokens/s and the chunk-normalised
time between tokens: A the engine pumped on the main thread, B the same
engine pumped on one other thread while the main thread waits, C an
`LLMServer` answering all 32 by `generate()` from 16 handler threads,
D `chip_smoke.py`'s `serving_1b_server` traffic (half streamed through a
poller). A against B isolates the pump's thread; B against C the
server's own work; C against D the streaming poller.

`pool` serves the same 32 greedy requests four ways, in turns (A B C D D
C B A), one line each with tokens/s, time to first token (the first
token's stamp minus the client's submit stamp) and time between tokens:
A one `LLMServer`, B an `LLMPool` of 1 replica, C an `LLMPool` of 2
replicas (members in this process), each by `generate()` from 16 handler
threads after an untimed first request a replica; D two bare engines,
16 requests each submitted at once, each pumped on a thread of its own.
A against B is the pool layer's cost; B against C what a second replica
buys when both pumps share the card and the interpreter lock; C against
D how much of that is the two pumps alone.

`moe` serves the same 32 greedy requests with the dense 1B (A) and the
1B-MoE (B: 8 experts, top-2, capacity routing at factor 1.25; both from
seed 0, both resident), in turns A B B A, one line each with tokens/s,
pump times and the launches of one greedy decode step of the 8-slot
batch (torch.profiler): the paired baseline for work on the MoE decode
step.
"""

import json
import os
import sys
import time

PARTIAL_REQUESTS, PARTIAL_PASSES = 32, 2


def partial_waves(smoke, decode_engine, cfg, params):
    import numpy as np
    import torch

    eng = decode_engine.RaggedDecoder(
        params, cfg, slots=8, max_len=288, chunk_tokens=32,
        prompt_buckets=(128,), device="cuda")
    rng = np.random.RandomState(smoke.SEED + 11)
    for rnd in range(PARTIAL_PASSES):
        prompts = [rng.randint(1, 30000, 128).astype(np.int32)
                   for _ in range(PARTIAL_REQUESTS)]
        news = [16 * (1 + i % 8) for i in range(PARTIAL_REQUESTS)]
        sids = [eng.submit(p, n) for p, n in zip(prompts, news)]
        pumps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.queue or any(st is not None for st in eng.slot_stream):
            queued, tp = len(eng.queue), time.perf_counter()
            eng.pump()
            pumps.append((time.perf_counter() - tp, queued - len(eng.queue)))
        dt = time.perf_counter() - t0
        lens = [len(eng.pop_finished(sid).tokens) for sid in sids]
        if lens != news:
            raise AssertionError(f"partial waves: streams ended with {lens}")
        admitting = [t for t, n in pumps if n > 0]
        waves: dict = {}
        for _, n in pumps:
            if n > 0:
                waves[n] = waves.get(n, 0) + 1
        smoke.emit({"phase": "serving_1b_partial_waves", "pass": rnd,
                    "requests": PARTIAL_REQUESTS, "seconds": dt,
                    "engine_tokens_per_sec": sum(lens) / dt,
                    "pumps": len(pumps),
                    "admitting_pump_s": float(np.mean(admitting)),
                    "decode_only_pump_s": float(np.mean(
                        [t for t, n in pumps if n == 0])),
                    "admitting_pumps_by_streams_admitted": waves})


def launches(fn) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def admission_widths(smoke, decode_engine, cfg, params):
    import numpy as np
    import torch

    cache = decode_engine.init_ragged_cache(cfg, 8, 288, device="cuda")
    cur_tok = torch.zeros((8,), dtype=torch.int32, device="cuda")
    rng = np.random.RandomState(smoke.SEED + 13)
    prompts = torch.from_numpy(rng.randint(1, 30000, (8, 128)).astype(
        np.int32)).cuda()
    row, count = {}, {}
    for n in (1, 2, 4, 8):
        row[n], count[n] = {}, {}
        for width in sorted({n, 8}):
            slots = np.where(np.arange(width) < n, np.arange(width), 8 + 1024)

            def admit():
                decode_engine._prefill_batch_into_slots(
                    params, prompts[:width], np.full((width,), 128, np.int32),
                    slots, cache, cur_tok, cfg)
            row[n][width] = smoke.time_ms(admit, iters=10, warmup=2)
            count[n][width] = launches(admit)
    active = torch.ones((8,), dtype=torch.bool, device="cuda")
    smoke.emit({"phase": "admission_prefill_ms", "by_streams_then_width": row,
                "launches_by_streams_then_width": count,
                "greedy_decode_step_launches": launches(
                    lambda: decode_engine.decode_chunk(
                        params, cache, cur_tok, active, cfg, 1))})


def engine(smoke) -> None:
    import torch

    from ray_tpu_torch.models import decode_engine, llama

    cfg = smoke.bench_1b_config()
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    params = llama.init_params(cfg, g, device="cuda")
    with torch.inference_mode():
        smoke.phase_serving(cfg, params)
        partial_waves(smoke, decode_engine, cfg, params)
        admission_widths(smoke, decode_engine, cfg, params)


def moe(smoke) -> None:
    """phase_serving's 32 greedy requests on the dense 1B (A) and on the
    1B-MoE (B, chip_smoke.moe_1b_config), both in memory, in turns A B B
    A: tokens/s, pump times and launches per greedy decode step each."""
    import torch

    from ray_tpu_torch.models import llama

    models = {}
    for tag, cfg in (("dense_1b", smoke.bench_1b_config()),
                     ("moe_1b", smoke.moe_1b_config())):
        g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
        models[tag] = (cfg, llama.init_params(cfg, g, device="cuda"))
    warm, prompts = smoke.serving_requests()
    lanes = [{}] * len(prompts)
    with torch.inference_mode():
        for tag in ("dense_1b", "moe_1b", "moe_1b", "dense_1b"):
            cfg, params = models[tag]
            eng = smoke.serving_engine(cfg, params)
            smoke.serve(eng, [warm], 32, lanes[:1])  # untimed
            pumps = []
            _, dt = smoke.serve(eng, prompts, 128, lanes, pumps=pumps)
            smoke.emit({"phase": "moe_ab", "model": tag,
                        "engine_tokens_per_sec": len(prompts) * 128 / dt,
                        **smoke.pump_times(pumps),
                        "greedy_step_launches": smoke.decode_step_launches(
                            cfg, params)["greedy_step"]})


def server(smoke) -> None:
    import threading

    import numpy as np
    import torch

    from ray_tpu_torch.serve import llm as serve_llm

    warm, prompts = smoke.serving_requests()
    new_tokens, chunk = 128, 32
    params, cfg = serve_llm.build_model("1b", max_len=288, seed=smoke.SEED,
                                        device="cuda")
    eng = smoke.serving_engine(cfg, params)
    smoke.serve(eng, [warm], 32, [{}])  # untimed

    def engine_main():
        streams, dt = smoke.serve(eng, prompts, new_tokens,
                                  [{}] * len(prompts))
        return dt, [s.token_times for s in streams]

    def engine_thread():
        out = []

        def run():  # inference mode is thread-local, as in LLMServer's pump
            with torch.inference_mode():
                out.append(engine_main())

        th = threading.Thread(target=run)
        th.start()
        th.join()
        return out[0]

    def with_server(fn):
        srv = serve_llm.LLMServer(
            "1b", slots=8, max_len=288, chunk_tokens=chunk,
            prompt_buckets=(128,), params_blob=params, device="cuda")
        srv.generate(warm.tolist(), 32)  # untimed
        try:
            results, dt = fn(srv)
        finally:
            if not srv.shutdown(30):
                raise AssertionError("the server did not drain")
        if any(len(r["tokens"]) != new_tokens for r in results):
            raise AssertionError("a request ended short")
        return dt, [r["token_times_s"] for r in results]

    def server_generate(srv):
        results = [None] * len(prompts)
        sem = threading.Semaphore(16)

        def one(i):
            with sem:
                results[i] = srv.generate(prompts[i].tolist(), new_tokens)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return results, time.perf_counter() - t0

    def server_mixed(srv):
        results, dt, *_ = smoke.serve_through_server(
            srv, prompts, new_tokens, lambda k: None)
        return results, dt

    modes = {"A_engine_main_thread": engine_main,
             "B_engine_other_thread": engine_thread,
             "C_server_generate": lambda: with_server(server_generate),
             "D_server_generate_and_stream": lambda: with_server(server_mixed)}
    order = list(modes) + list(modes)[::-1]
    with torch.inference_mode():
        for turn, name in enumerate(order):
            dt, stamps = modes[name]()
            gaps = np.concatenate([np.diff(np.asarray(t)) for t in stamps])
            smoke.emit({"phase": "server_ab", "turn": turn, "mode": name,
                        "card": smoke.card(), "seconds": dt,
                        "tokens_per_sec": len(prompts) * new_tokens / dt,
                        "tbt_ms_p50": 1e3 * float(np.percentile(
                            gaps[gaps > 0] / chunk, 50))})


def pool(smoke) -> None:
    import threading

    import numpy as np
    import torch

    from ray_tpu_torch.serve import llm as serve_llm
    from ray_tpu_torch.serve import llm_pool

    warm, prompts = smoke.serving_requests()
    new_tokens, chunk = 128, 32
    kw = dict(slots=8, max_len=288, chunk_tokens=chunk, prompt_buckets=(128,),
              seed=smoke.SEED, device="cuda")

    def run_all(fns):
        errors = []

        def guarded(fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=guarded, args=(fn,)) for fn in fns]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError("a handler thread did not end")
        if errors:
            raise errors[0]

    def traffic(target, replicas):
        # one first prefill + chunk a replica, untimed
        run_all([lambda: target.generate(warm.tolist(), 32)] * replicas)
        results = [None] * len(prompts)
        sem = threading.Semaphore(16)

        def one(i):
            with sem:
                t = time.perf_counter()
                results[i] = (t, target.generate(prompts[i].tolist(),
                                                 new_tokens))

        t0 = time.perf_counter()
        run_all([lambda i=i: one(i) for i in range(len(prompts))])
        dt = time.perf_counter() - t0
        if any(len(r["tokens"]) != new_tokens for _, r in results):
            raise AssertionError("a request ended short")
        return dt, results

    def server():
        srv = serve_llm.LLMServer("1b", **kw)
        try:
            return traffic(srv, 1)
        finally:
            if not srv.shutdown(30):
                raise AssertionError("the server did not drain")

    def pool_of(n):
        def run():
            p = llm_pool.LLMPool("1b", min_replicas=n, max_replicas=n,
                                 autoscale=False, **kw)
            try:
                return traffic(p, n)
            finally:
                p.shutdown()
        return run

    def engines_on_two_threads():
        # no server and no pool: two engines, each pumped on a thread of
        # its own, 16 requests each, submitted up front
        params, cfg = serve_llm.build_model("1b", max_len=288, seed=smoke.SEED,
                                            device="cuda")
        engs = [smoke.serving_engine(cfg, params) for _ in range(2)]
        for eng in engs:
            smoke.serve(eng, [warm], 32, [{}])  # untimed
        out = [None, None]

        def drain(j):
            with torch.inference_mode():  # thread-local, as in the pump
                t = time.perf_counter()
                streams, _ = smoke.serve(engs[j], prompts[j::2], new_tokens,
                                         [{}] * 16)
                out[j] = [(t, {"tokens": st.tokens,
                               "token_times_s": st.token_times})
                          for st in streams]

        t0 = time.perf_counter()
        run_all([lambda j=j: drain(j) for j in range(2)])
        return time.perf_counter() - t0, out[0] + out[1]

    modes = {"A_server": server, "B_pool_1_replica": pool_of(1),
             "C_pool_2_replicas": pool_of(2),
             "D_two_engines_two_threads": engines_on_two_threads}
    order = list(modes) + list(modes)[::-1]
    with torch.inference_mode():
        for turn, name in enumerate(order):
            dt, results = modes[name]()
            ttft = [r["token_times_s"][0] - t for t, r in results]
            gaps = np.concatenate([np.diff(r["token_times_s"])
                                   for _, r in results])
            smoke.emit({"phase": "pool_ab", "turn": turn, "mode": name,
                        "card": smoke.card(), "seconds": dt,
                        "tokens_per_sec": len(prompts) * new_tokens / dt,
                        "ttft_s": smoke.percentiles(ttft),
                        "tbt_ms": smoke.percentiles(gaps[gaps > 0] / chunk,
                                                    1e3)})


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as smoke
    from ray_tpu_torch.ops import flash_attention as fa

    smoke.phase_device()
    if sys.argv[2:] == ["server"]:
        server(smoke)
        return
    if sys.argv[2:] == ["pool"]:
        pool(smoke)
        return
    if sys.argv[2:] == ["moe"]:
        moe(smoke)
        return
    libs = [p[:-3] for p in os.listdir("ray_tpu_torch/csrc") if p.endswith(".cu")]
    smoke._kernels.build(sorted(libs))
    if sys.argv[2:] == ["engine"]:
        engine(smoke)
        return
    row = {"checkout": sys.argv[1]}
    for tag, shape in (("fwd_1b", (2, 16, 8, 2048, 2048, 128)),
                       ("fwd_350m", (8, 8, 8, 2048, 2048, 128))):
        q, k, v = smoke.flash_inputs(*shape, torch.bfloat16, 1)
        row[tag] = smoke.time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                                 iters=50)
    for tag, shape in (("bwd_350m", (8, 8, 8, 2048, 2048, 128)),
                       ("bwd_1b", (2, 16, 8, 2048, 2048, 128))):
        args = smoke.bwd_inputs(*shape, torch.bfloat16, True, 3)
        row[tag] = smoke.time_ms(lambda: fa.flash_bwd_fused(*args, causal=True), iters=30)
    # the long-context route's two kernels (T=S=16384, 350m width)
    args = smoke.bwd_inputs(1, 8, 8, 16384, 16384, 128, torch.bfloat16, True, 5)
    row["dq_16k"] = smoke.time_ms(lambda: fa.flash_bwd_dq(*args, causal=True), iters=10)
    row["dkv_16k"] = smoke.time_ms(lambda: fa.flash_bwd_dkv(*args, causal=True), iters=10)
    row["launches"] = fa.launch_counts()
    smoke.emit(row)


if __name__ == "__main__":
    main()
