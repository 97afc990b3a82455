"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain torch version on the card, drives the inference
path at the full width of Llama-1B (a scoring forward through the flash
kernel, then the continuous-batching engine serving 32 requests, whose
outputs are scored again), checks the results, and prints one JSON line
per phase. The line before the last lists every kernel with its launches
on the main path, error, time, the plain version's time, the library
call's time and the card's bound; the last line is
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
non-zero and no result line is printed. Needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.models import decode_engine, llama
from ray_tpu_torch.ops import flash_attention as fa

SEED = 0
# Datasheet peaks (dense): bf16 tensor-core FLOP/s and HBM bytes/s.
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}
# Kernel-vs-plain tolerances. bf16: p is rounded to bf16 before P.V on
# both sides, and an f32 exp that differs in its last bit can round to
# the neighbouring bf16 value; lse sums f32 terms in another order. f32:
# both sides run full f32 (TF32 off, set below).
TOL = {torch.bfloat16: dict(out=2e-2, lse=1e-3),
       torch.float32: dict(out=1e-4, lse=1e-4)}
# (name, B, Hq, Hkv, T, S, D, causal, dtype); the first is the main path's
FLASH_CASES = [
    ("main_1b", 2, 16, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("multi_tile_s4096", 1, 16, 8, 4096, 4096, 128, True, torch.bfloat16),
    ("decode_t1_s300", 2, 16, 8, 1, 300, 128, True, torch.bfloat16),
    ("empty_rows_t64_s32", 2, 16, 8, 64, 32, 128, True, torch.bfloat16),
    ("noncausal_mha_d64", 2, 12, 12, 333, 777, 64, False, torch.bfloat16),
    ("f32_gqa_d128", 1, 8, 4, 300, 300, 128, True, torch.float32),
    ("tiny_d16", 2, 4, 2, 200, 200, 16, True, torch.bfloat16),
    ("d32", 1, 8, 2, 100, 100, 32, True, torch.bfloat16),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_inputs(b, hq, hkv, t, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return rnd(b, hq, t, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)


def flash_bound(b, hq, hkv, t, s, d, causal, dtype, peaks):
    """Least time for the forward on this card: the larger of its
    tensor-core operations (only the (q, k) pairs the mask keeps) over
    the peak rate and its bytes (q, k, v read once, out and lse written
    once) over the memory rate."""
    if causal:
        rows = np.arange(t) + (s - t) + 1
        pairs = int(np.clip(rows, 0, s).sum())
    else:
        pairs = t * s
    flops = 4.0 * b * hq * d * pairs
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * b * hq * t * d + 2 * b * hkv * s * d) + 4 * b * hq * t
    flop_peak = peaks[0] if dtype == torch.bfloat16 else 67e12
    t_ops, t_bytes = flops / flop_peak, nbytes / peaks[1]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False); this run needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name,
          "count": torch.cuda.device_count(),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    return name, smi, PEAKS["pcie" if "PCIe" in name else "sxm"]


def phase_build():
    t0 = time.perf_counter()
    paths = _kernels.build(["flash_fwd"])
    log = paths["flash_fwd"].with_suffix(".log")
    ptxas = log.read_text() if log.exists() else "(cached build)"
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "libs": {k: v.name for k, v in paths.items()},
          "ptxas": [ln for ln in ptxas.splitlines()
                    if "registers" in ln or "spill" in ln][:16]})


def phase_kernel_vs_plain():
    results = {}
    for i, (name, b, hq, hkv, t, s, d, causal, dtype) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(b, hq, hkv, t, s, d, dtype, SEED + i)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = TOL[dtype]
        ok = (bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), ref_out.float(),
                                 atol=tol["out"], rtol=tol["out"])
              and torch.allclose(lse, ref_lse, atol=tol["lse"], rtol=0))
        emit({"phase": "kernel_vs_plain", "case": name,
              "shape": dict(B=b, Hq=hq, Hkv=hkv, T=t, S=s, D=d),
              "causal": causal, "dtype": str(dtype).split(".")[-1],
              "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
              "tol": tol, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version on {name}: out {err_out}, "
                                 f"lse {err_lse} (tol {tol})")
        results[name] = max(err_out, err_lse)
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return results


def bench_1b_config():
    """Llama-1B at full width, as the repo's serving benchmark sizes it
    (vocab 32128, max_seq_len 288, bf16)."""
    base = llama.llama2_size("1b")
    return llama.LlamaConfig(**{**base.__dict__, "vocab_size": 32128,
                                "max_seq_len": 288, "dtype": "bfloat16"})


def phase_scoring(cfg, params):
    b, t = 2, 2048
    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    toks = torch.randint(1, 30000, (b, t), generator=g, device="cuda")
    fa.reset_launch_count()
    logits = llama.forward(params, toks, cfg)
    torch.cuda.synchronize()
    launches = fa.launch_count()
    if launches != cfg.n_layers:
        raise AssertionError(f"scoring forward launched flash_fwd "
                             f"{launches} times, expected {cfg.n_layers}")
    ref_cfg = llama.LlamaConfig(**{**cfg.__dict__, "use_flash": False})
    ref = llama.forward(params, toks, ref_cfg)
    diff = (logits.float() - ref.float())
    rel = (diff.norm() / ref.float().norm()).item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    ms = time_ms(lambda: llama.forward(params, toks, cfg), iters=5, warmup=1)
    ms_ref = time_ms(lambda: llama.forward(params, toks, ref_cfg), iters=5,
                     warmup=1)
    # bf16 through 22 layers: every matmul output and residual add is
    # rounded to 8 mantissa bits (2**-8 ~ 4e-3 relative per rounding) on
    # both paths, at different places inside attention, and the random
    # weights pass the differences on layer to layer
    rel_tol = 5e-2
    ok = bool(torch.isfinite(logits.float()).all()) and rel <= rel_tol
    emit({"phase": "scoring_forward_1b", "batch": b, "seq": t,
          "flash_launches": launches, "logits_shape": list(logits.shape),
          "rel_l2_err_vs_reference_attention": rel, "rel_tol": rel_tol,
          "max_abs_err": diff.abs().max().item(), "top1_agreement": top1,
          "forward_ms": ms, "tokens_per_sec": b * t / (ms / 1e3),
          "reference_attention_forward_ms": ms_ref, "ok": ok})
    if not ok:
        raise AssertionError(f"1B logits: rel err {rel} > {rel_tol}")
    return launches


def phase_serving(cfg, params):
    prompt_len, new_tokens, n_requests, slots = 128, 128, 32, 8
    eng = decode_engine.RaggedDecoder(
        params, cfg, slots=slots, max_len=prompt_len + new_tokens + 32,
        chunk_tokens=32, prompt_buckets=(prompt_len,), device="cuda")
    rng = np.random.RandomState(SEED)

    def req():
        return rng.randint(1, 30000, prompt_len).astype(np.int32)

    warm = eng.submit(req(), 32)  # first prefill + chunk, untimed
    eng.drain()
    eng.pop_finished(warm)
    prompts = [req() for _ in range(n_requests)]
    fa.reset_launch_count()
    sids = [eng.submit(p, new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    streams = [eng.pop_finished(s) for s in sids]
    lens = [len(s.tokens) if s is not None else 0 for s in streams]
    if lens != [new_tokens] * n_requests:
        raise AssertionError(f"streams did not all finish with "
                             f"{new_tokens} tokens: {lens}")
    engine_launches = fa.launch_count()
    # score the served sequences with the scoring forward
    seqs = torch.from_numpy(np.stack([
        np.concatenate([p, np.asarray(s.tokens, np.int32)])
        for p, s in zip(prompts, streams)])).cuda()
    logits = llama.forward(params, seqs, cfg)
    torch.cuda.synchronize()
    score_launches = fa.launch_count() - engine_launches
    if score_launches != cfg.n_layers:
        raise AssertionError(f"scoring the served sequences launched "
                             f"flash_fwd {score_launches} times")
    pred = logits[:, prompt_len - 1:-1].argmax(-1).cpu()
    served = seqs[:, prompt_len:].cpu()
    match = (pred == served).float().mean().item()
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("non-finite logits scoring served sequences")
    emit({"phase": "serving_1b", "requests": n_requests, "slots": slots,
          "prompt_len": prompt_len, "new_tokens": new_tokens,
          "chunk_tokens": 32, "seconds": dt,
          "engine_tokens_per_sec": sum(lens) / dt,
          "engine_flash_launches": engine_launches,
          "scoring_flash_launches": score_launches,
          "served_equals_teacher_forced_argmax": match,
          "stats": eng.stats()})
    return engine_launches + score_launches


def phase_exactness_f32():
    """Engine tokens equal greedy_generate's on a float32 copy at reduced
    depth (2 layers, full 1B width)."""
    cfg = llama.LlamaConfig(**{**bench_1b_config().__dict__,
                               "n_layers": 2, "dtype": "float32"})
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = llama.init_params(cfg, g, device="cuda")
    eng = decode_engine.RaggedDecoder(
        params, cfg, slots=8, max_len=288, chunk_tokens=32,
        prompt_buckets=(64, 128), device="cuda")
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, 30000, int(n)).astype(np.int32)
               for n in rng.randint(40, 129, 12)]
    new_tokens = 32
    sids = [eng.submit(p, new_tokens) for p in prompts]
    eng.drain()
    mismatched = []
    for sid, p in zip(sids, prompts):
        s = eng.pop_finished(sid)
        ref = llama.greedy_generate(params, torch.from_numpy(p[None]).cuda(),
                                    cfg, new_tokens)[0, len(p):].tolist()
        if s.tokens != ref:
            mismatched.append(sid)
    emit({"phase": "exactness_f32_2layer", "streams": len(prompts),
          "new_tokens": new_tokens, "mismatched_streams": mismatched,
          "ok": not mismatched})
    if mismatched:
        raise AssertionError(f"engine != greedy_generate on {mismatched}")


def phase_kernels_line(errs, launches, peaks):
    name, b, hq, hkv, t, s, d, causal, dtype = FLASH_CASES[0]
    q, k, v = flash_inputs(b, hq, hkv, t, s, d, dtype, SEED)
    bound_ms, bound_by, flops, nbytes = flash_bound(
        b, hq, hkv, t, s, d, causal, dtype, peaks)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # turns: plain, kernel, kernel, plain, library
    plain_a = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=causal), 5)
    kern_a = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    kern_b = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain_b = time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=causal), 5)
    lib = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    ms = min(kern_a, kern_b)
    emit({"phase": "kernel_timing", "case": name, "kernel_ms": [kern_a, kern_b],
          "plain_ms": [plain_a, plain_b], "sdpa_ms": lib, "flops": flops,
          "bytes": nbytes, "bound_ms": bound_ms,
          "achieved_tflops": flops / (ms / 1e3) / 1e12,
          "share_of_bound": bound_ms / ms})
    return [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:294",
        "launches": launches, "max_abs_err": errs[name], "ms": ms,
        "plain_ms": min(plain_a, plain_b), "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib,
    }]


def main() -> None:
    name, smi, peaks = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 checks are full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    phase_build()
    errs = phase_kernel_vs_plain()
    cfg = bench_1b_config()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, g, device="cuda")
    emit({"phase": "init_1b", "n_params": cfg.num_params(),
          "layers": cfg.n_layers, "d_model": cfg.d_model})
    with torch.inference_mode():
        launches = phase_scoring(cfg, params)
        launches += phase_serving(cfg, params)
        del params
        torch.cuda.empty_cache()
        phase_exactness_f32()
        kernels = phase_kernels_line(errs, launches, peaks)
    emit({"phase": "memory",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30})
    print(smi.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
