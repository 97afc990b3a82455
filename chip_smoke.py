"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain torch version on the card, drives the inference
path at the full width of Llama-1B (a scoring forward through the flash
kernel, then the continuous-batching engine serving 32 requests, whose
outputs are scored again), then the training path: Llama-350m at B=8 x
T=2048 and Llama-1B at B=2 x T=2048, both at full width and depth
(bench.py's headline configurations), a 2-layer 350m-width step at
T=16384 that takes the dq + dkv backward kernels, and an f32 check of
every gradient against the reference attention. Every bf16 head_dim-128
flash call on those paths must go through the Hopper kernels
(flash_fwd_sm90, flash_bwd_fused_sm90, and past 8192 keys
flash_bwd_dq_sm90 + flash_bwd_dkv_sm90), which the launch counts by
entry point show. It checks the results and prints one JSON line per
phase. The line before the last lists every main-path kernel with its
launches on the main paths, error, time (eager, and replayed from a CUDA
graph), the plain version's time, the library call's time, the card's
bound, its share of that bound, ptxas's registers and, for dq and dkv,
the time of the mma.sync kernel each replaced; the last line is
{"ok": true, "device": {...}}. Any
failure raises: the exit code is then non-zero and no result line is
printed. Needs one CUDA device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch import _kernels, train
from ray_tpu_torch.models import decode_engine, llama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten

SEED = 0
# Datasheet peaks (dense): bf16 tensor-core FLOP/s and HBM bytes/s.
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}
# Kernel-vs-plain tolerances. bf16: p is rounded to bf16 before P.V on
# both sides, and an f32 exp that differs in its last bit can round to
# the neighbouring bf16 value; lse sums f32 terms in another order. f32:
# both sides run full f32 (TF32 off, set below).
TOL = {torch.bfloat16: dict(out=2e-2, lse=1e-3),
       torch.float32: dict(out=1e-4, lse=1e-4)}
# (name, B, Hq, Hkv, T, S, D, causal, dtype); the first three are the
# main paths' (1B scoring, 350m training, long-context training). bf16 at
# D=128 takes flash_fwd_sm90 (the edges of its 128-row q tiles and
# 128-key tiles below), the rest flash_fwd.
FLASH_CASES = [
    ("main_1b", 2, 16, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("main_350m_train", 8, 8, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("long_ctx_350m", 1, 8, 8, 16384, 16384, 128, True, torch.bfloat16),
    ("multi_tile_s4096", 1, 16, 8, 4096, 4096, 128, True, torch.bfloat16),
    ("decode_t1_s300", 2, 16, 8, 1, 300, 128, True, torch.bfloat16),
    ("empty_rows_t64_s32", 2, 16, 8, 64, 32, 128, True, torch.bfloat16),
    ("ragged_gqa2_t333_s777", 2, 8, 4, 333, 777, 128, True, torch.bfloat16),
    ("ragged_noncausal_gqa4", 1, 8, 2, 333, 777, 128, False, torch.bfloat16),
    ("empty_rows_gqa4_t300_s100", 1, 8, 2, 300, 100, 128, True, torch.bfloat16),
    ("s_lt_128_t77_s50", 2, 4, 4, 77, 50, 128, True, torch.bfloat16),
    ("s_lt_128_noncausal", 1, 4, 2, 200, 90, 128, False, torch.bfloat16),
    ("noncausal_mha_d64", 2, 12, 12, 333, 777, 64, False, torch.bfloat16),
    ("f32_gqa_d128", 1, 8, 4, 300, 300, 128, True, torch.float32),
    ("tiny_d16", 2, 4, 2, 200, 200, 16, True, torch.bfloat16),
    ("d32", 1, 8, 2, 100, 100, 32, True, torch.bfloat16),
]
# Backward kernels against their plain versions, on
# max|kernel - plain| / max|plain| per output. bf16: both sides round p
# and ds to bf16 before their products, and an f32 value that differs in
# its last bit (exp2, sums in another order, dq's f32 atomics in a
# run-dependent order) can round to the neighbouring bf16 value, a step
# of 2**-8 of one term; the outputs are rounded to bf16 once. f32: full
# f32 on both sides (TF32 off); only the order of the sums differs.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# (name, B, Hq, Hkv, T, S, D, causal, dtype, route); the first case of
# each route is its main path's shape. At bf16 D=128 the fused route
# takes flash_bwd_fused_sm90 and the split route flash_bwd_dq_sm90 +
# flash_bwd_dkv_sm90 (the edges of their 64/128-key and 64/128-row tiles
# below); the rest take flash_bwd_fused or flash_bwd_dq + flash_bwd_dkv.
BWD_CASES = [
    ("main_350m", 8, 8, 8, 2048, 2048, 128, True, torch.bfloat16, "fused"),
    ("gqa_1b", 2, 16, 8, 2048, 2048, 128, True, torch.bfloat16, "fused"),
    ("ragged_gqa2_t333_s777", 2, 8, 4, 333, 777, 128, True, torch.bfloat16, "fused"),
    ("ragged_noncausal_gqa4", 1, 8, 2, 333, 777, 128, False, torch.bfloat16, "fused"),
    ("empty_rows_gqa4_t300_s100", 1, 8, 2, 300, 100, 128, True, torch.bfloat16, "fused"),
    ("s_lt_128_t77_s50", 2, 4, 4, 77, 50, 128, True, torch.bfloat16, "fused"),
    ("s_lt_128_noncausal", 1, 4, 2, 200, 90, 128, False, torch.bfloat16, "fused"),
    ("decode_t1_s300", 2, 8, 4, 1, 300, 128, True, torch.bfloat16, "fused"),
    ("ragged_noncausal_d64", 2, 12, 12, 333, 777, 64, False, torch.bfloat16, "fused"),
    ("empty_rows_t64_s32", 2, 4, 2, 64, 32, 64, True, torch.bfloat16, "fused"),
    ("f32_gqa_d128", 1, 8, 4, 300, 300, 128, True, torch.float32, "fused"),
    ("d16", 2, 4, 2, 200, 200, 16, True, torch.bfloat16, "fused"),
    ("d32", 1, 8, 2, 100, 100, 32, True, torch.bfloat16, "fused"),
    ("long_ctx_350m", 1, 8, 8, 16384, 16384, 128, True, torch.bfloat16, "split"),
    ("test_ops_long_kv_f32", 1, 1, 1, 256, 16384, 32, True, torch.float32, "split"),
    ("gqa_d128_s12288", 1, 16, 8, 1024, 12288, 128, True, torch.bfloat16, "split"),
    # ragged edges on the two-kernel path: T over 64-row blocks, S over
    # 32-key tiles and past 8192 keys
    ("ragged_split_gqa", 1, 4, 2, 333, 8777, 64, True, torch.bfloat16, "split"),
    ("ragged_split_noncausal", 1, 4, 4, 999, 9001, 128, False, torch.bfloat16, "split"),
    ("ragged_split_f32", 1, 2, 1, 77, 8200, 32, True, torch.float32, "split"),
    ("empty_rows_split", 1, 2, 1, 8300, 8200, 32, True, torch.bfloat16, "split"),
    # the Hopper dq and dkv kernels' edges: ragged T and S, GQA 2 and 4,
    # rows (and, at T - S >= 128, whole 128-row dq blocks) that see no
    # key, a single query row
    ("ragged_split_gqa_d128", 1, 4, 2, 333, 8777, 128, True, torch.bfloat16, "split"),
    ("empty_rows_split_d128", 1, 2, 1, 8300, 8200, 128, True, torch.bfloat16, "split"),
    ("empty_blocks_split_d128", 1, 2, 1, 8500, 8200, 128, True, torch.bfloat16, "split"),
    ("t1_split_s8300", 1, 8, 4, 1, 8300, 128, True, torch.bfloat16, "split"),
    ("noncausal_split_gqa4", 1, 8, 2, 999, 9001, 128, False, torch.bfloat16, "split"),
]
BWD_KERNELS = {
    "flash_bwd_fused": (fa.flash_bwd_fused, fa.flash_bwd_fused_plain, ("dq", "dk", "dv")),
    "flash_bwd_dq": (fa.flash_bwd_dq, fa.flash_bwd_dq_plain, ("dq",)),
    "flash_bwd_dkv": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, ("dk", "dv")),
}
# tensor-core products per kept (q, k) pair and head, 2*D flops each
PRODUCTS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4}
LIBS = ("flash_fwd", "flash_bwd", "flash_fwd_sm90", "flash_bwd_sm90",
        "flash_bwd_dq_sm90")
# entry point -> (its kernel function in ptxas's report, the C function
# that returns its shared memory): the ones a main path takes at bf16
# D=128, and the mma.sync dq and dkv kernels the Hopper ones replaced
KERNEL_SYMBOLS = {
    "flash_fwd_sm90": ("flash_fwd_sm90_kernel", "flash_fwd_sm90_smem_bytes"),
    "flash_bwd_fused_sm90": ("flash_bwd_sm90_kernelILb1E",
                             "flash_bwd_fused_sm90_smem_bytes"),
    "flash_bwd_dq_sm90": ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_sm90_smem_bytes"),
    "flash_bwd_dkv_sm90": ("flash_bwd_sm90_kernelILb0E", "flash_bwd_dkv_sm90_smem_bytes"),
    "flash_bwd_dq": ("flash_bwd_dq_bf16ILi128EE", None),
    "flash_bwd_dkv": ("flash_bwd_kv_bf16ILi128ELb0EE", None),
}
# the Hopper kernels: ptxas must report no spills for them
NEW_KERNELS = ("flash_fwd_sm90", "flash_bwd_fused_sm90", "flash_bwd_dq_sm90",
               "flash_bwd_dkv_sm90")


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, replayed from a CUDA graph of `iters`
    calls: no host time between the launches, which an eager loop of a
    short kernel can otherwise measure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as it requires
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_inputs(b, hq, hkv, t, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return rnd(b, hq, t, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)


def flash_bound(b, hq, hkv, t, s, d, causal, dtype, peaks, kernel="flash_fwd"):
    """Least time for a flash kernel on this card: the larger of its
    tensor-core operations (2*D flops per product per (q, k) pair the
    mask keeps) over the peak rate and its bytes (each input read once,
    each output written once) over the memory rate. Forward: q, k, v in,
    out and lse out. Backward: q, k, v, do, lse and delta in; dq (dq
    kernel), dk and dv (dkv kernel) or all three (fused) out."""
    if causal:
        rows = np.arange(t) + (s - t) + 1
        pairs = int(np.clip(rows, 0, s).sum())
    else:
        pairs = t * s
    flops = 2.0 * PRODUCTS[kernel] * b * hq * d * pairs
    esize = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes, row_bytes = (esize * b * hq * t * d,
                                    esize * b * hkv * s * d, 4 * b * hq * t)
    if kernel == "flash_fwd":
        nbytes = 2 * q_bytes + 2 * kv_bytes + row_bytes
    else:
        nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes  # inputs
        nbytes += {"flash_bwd_fused": q_bytes + 2 * kv_bytes,
                   "flash_bwd_dq": q_bytes,
                   "flash_bwd_dkv": 2 * kv_bytes}[kernel]
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


def ptxas_report(text):
    """ptxas -v's report per kernel function: {mangled name: {"registers",
    "spill_bytes"}}; and its warnings (wgmma serialised, setmaxnreg
    ignored, ...)."""
    funcs, name, warnings = {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            funcs[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            funcs[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            funcs[name]["registers"] = int(m.group(1))
        if "warning" in ln:
            warnings.append(ln.strip())
    return funcs, warnings


def phase_build():
    """Builds every library (one nvcc each, together) and reads ptxas's
    report: the Hopper kernels must not spill. Returns {entry point:
    {"registers", "spill_bytes", "smem_bytes"}} for KERNEL_SYMBOLS."""
    t0 = time.perf_counter()
    paths = _kernels.build(list(LIBS))
    seconds = time.perf_counter() - t0
    funcs, warnings = {}, {}
    for lib, path in paths.items():
        log = path.with_suffix(".log")
        f, w = ptxas_report(log.read_text() if log.exists() else "")
        funcs.update(f)
        warnings[lib] = w
    info = {}
    for entry, (symbol, smem_fn) in KERNEL_SYMBOLS.items():
        found = [v for k, v in funcs.items() if symbol in k]
        if len(found) != 1:
            raise AssertionError(f"ptxas report: {len(found)} functions match "
                                 f"{symbol}")
        info[entry] = dict(found[0])
        if smem_fn:
            lib = _kernels.load(fa._LIBRARY[entry])
            info[entry]["smem_bytes"] = getattr(lib, smem_fn)()
    spills = {e: i for e, i in info.items()
              if e in NEW_KERNELS and i.get("spill_bytes", 1) != 0}
    emit({"phase": "build", "seconds": round(seconds, 2),
          "libs": {k: v.name for k, v in paths.items()}, "kernels": info,
          "ptxas_warnings": warnings, "ok": not spills})
    if spills:
        raise AssertionError(f"the Hopper kernels spill: {spills}")
    return info


def launched_only(variant, counts):
    """Raise unless `counts` (launches by entry point) show `variant` and
    no other kernel."""
    others = {k: n for k, n in counts.items() if n and k != variant}
    if counts.get(variant, 0) == 0 or others:
        raise AssertionError(f"expected launches of {variant} only, got {counts}")


def phase_kernel_vs_plain():
    results = {}
    for i, (name, b, hq, hkv, t, s, d, causal, dtype) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(b, hq, hkv, t, s, d, dtype, SEED + i)
        variant = fa.kernel_variant("flash_fwd", "cuda", dtype, d)
        fa.reset_launch_count()
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        launched_only(variant, fa.launch_counts())
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = TOL[dtype]
        ok = (bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), ref_out.float(),
                                 atol=tol["out"], rtol=tol["out"])
              and torch.allclose(lse, ref_lse, atol=tol["lse"], rtol=0))
        emit({"phase": "kernel_vs_plain", "case": name, "variant": variant,
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
    # a tensor that TMA cannot read (not 16-byte aligned) is refused
    q, k, v = flash_inputs(1, 2, 2, 64, 64, 128, torch.bfloat16, SEED)
    shifted = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    q_bad = shifted[1:1 + q.numel()].view(q.shape).copy_(q)
    try:
        fa.flash_attention_fwd(q_bad, k, v, causal=True)
    except ValueError as err:
        emit({"phase": "misaligned_refused", "data_ptr_mod_16":
              q_bad.data_ptr() % 16, "error": str(err)})
    else:
        raise AssertionError("flash_fwd_sm90 took a misaligned q")
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
    counts = fa.launch_counts()
    launched_only("flash_fwd_sm90", counts)
    launches = counts["flash_fwd_sm90"]
    if launches != cfg.n_layers:
        raise AssertionError(f"scoring forward launched flash_fwd_sm90 "
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
    return counts


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
    launched_only("flash_fwd_sm90", fa.launch_counts())
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
    return fa.launch_counts()


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


def bwd_inputs(b, hq, hkv, t, s, d, dtype, causal, seed):
    """q, k, v, do (seeded) and the forward kernel's residuals, as the
    backward gets them: (q, k, v, do, lse, delta)."""
    q, k, v = flash_inputs(b, hq, hkv, t, s, d, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(dim=-1)
    return q, k, v, do, lse, delta


def entry_point(kernel, dtype, d):
    """The C entry point that wrapper `kernel` launches on the card."""
    return fa.kernel_variant(kernel, "cuda", dtype, d)


def bwd_errors(kernel, args, causal):
    """Run a backward kernel and its plain version on the same inputs:
    {output: (max abs error, error / max |plain|)}. Raises unless the
    wrapper launched the entry point that `entry_point` names."""
    fn, plain, names = BWD_KERNELS[kernel]
    fa.reset_launch_count()
    got = fn(*args, causal=causal)
    torch.cuda.synchronize()
    launched_only(entry_point(kernel, args[0].dtype, args[0].shape[3]),
                  fa.launch_counts())
    want = plain(*args, causal=causal)
    if len(names) == 1:
        got, want = (got,), (want,)
    return output_errors(kernel, names, got, want), got


def output_errors(kernel, names, got, want):
    """{output: (max abs error, error / max |plain|)} of a kernel's outputs
    `got` against its plain version's `want`; raises on a non-finite
    output."""
    errs = {}
    for name, a, w in zip(names, got, want):
        a, w = a.float(), w.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{kernel}: non-finite {name}")
        err = (a - w).abs().max().item()
        errs[name] = (err, err / max(w.abs().max().item(), 1e-30))
    return errs


def phase_bwd_kernel_vs_plain():
    results = {}
    for i, (name, b, hq, hkv, t, s, d, causal, dtype, route) in enumerate(BWD_CASES):
        if fa._use_fused_bwd(t, s) != (route == "fused"):
            raise AssertionError(f"{name}: the gate does not take the {route} path")
        args = bwd_inputs(b, hq, hkv, t, s, d, dtype, causal, SEED + 50 + i)
        kernels = (["flash_bwd_fused"] if route == "fused"
                   else ["flash_bwd_dq", "flash_bwd_dkv"])
        for kernel in kernels:
            errs, got = bwd_errors(kernel, args, causal)
            tol = BWD_TOL[dtype]
            ok = all(rel <= tol for _, rel in errs.values())
            if t > s and causal and "dq" in errs:  # rows that see no key
                ok = ok and bool((got[0][:, :, :t - s] == 0).all())
            emit({"phase": "bwd_kernel_vs_plain", "kernel": kernel, "case": name,
                  "entry_point": entry_point(kernel, dtype, d),
                  "shape": dict(B=b, Hq=hq, Hkv=hkv, T=t, S=s, D=d),
                  "causal": causal, "dtype": str(dtype).split(".")[-1],
                  "max_abs_err": {k: e for k, (e, _) in errs.items()},
                  "err_over_max_ref": {k: r for k, (_, r) in errs.items()},
                  "tol_over_max_ref": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"{kernel} disagrees with its plain "
                                     f"version on {name}: {errs} (tol {tol})")
            results[(kernel, name)] = max(e for e, _ in errs.values())
            del got
        del args
    torch.cuda.empty_cache()
    return results


def phase_bwd_determinism():
    """Two launches of each split-route kernel on the long-context inputs
    give the same bits (no atomics in either)."""
    name, b, hq, hkv, t, s, d, causal, dtype, _ = next(
        c for c in BWD_CASES if c[0] == "long_ctx_350m")
    args = bwd_inputs(b, hq, hkv, t, s, d, dtype, causal, SEED + 600)
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        fn = BWD_KERNELS[kernel][0]
        entry = entry_point(kernel, dtype, d)
        fa.reset_launch_count()
        first, second = fn(*args, causal=causal), fn(*args, causal=causal)
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        if kernel == "flash_bwd_dq":
            first, second = (first,), (second,)
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        emit({"phase": "bwd_determinism", "case": name, "entry_point": entry,
              "launches": counts[entry], "bitwise_equal": same})
        if counts[entry] != 2 or not same:
            raise AssertionError(f"{entry}: two launches on {name} differ "
                                 f"(launches {counts})")
        del first, second
    del args
    torch.cuda.empty_cache()


# (B, Hq, Hkv, T, S, D), bf16, causal: both backward routes timed on each
ROUTE_SHAPES = [(8, 8, 8, 2048, 2048, 128), (1, 8, 8, 8192, 8192, 128),
                (1, 8, 8, 12288, 12288, 128), (1, 8, 8, 16384, 16384, 128),
                (1, 16, 8, 1024, 12288, 128)]


def phase_bwd_routes():
    """The gate's two routes on the same inputs, in turns fused, dq + dkv,
    dq + dkv, fused: the data behind _use_fused_bwd's threshold (timed
    only; each route is held to its plain version above)."""
    rows = []
    for i, (b, hq, hkv, t, s, d) in enumerate(ROUTE_SHAPES):
        args = bwd_inputs(b, hq, hkv, t, s, d, torch.bfloat16, True,
                          SEED + 700 + i)
        fused = lambda: fa.flash_bwd_fused(*args, causal=True)  # noqa: E731

        def split():
            fa.flash_bwd_dq(*args, causal=True)
            fa.flash_bwd_dkv(*args, causal=True)

        f_a, s_a, s_b, f_b = time_ms(fused), time_ms(split), time_ms(split), time_ms(fused)
        row = {"shape": dict(B=b, Hq=hq, Hkv=hkv, T=t, S=s, D=d),
               "fused_ms": [f_a, f_b], "dq_plus_dkv_ms": [s_a, s_b],
               "fused_over_split": min(f_a, f_b) / min(s_a, s_b),
               "gate_takes": "fused" if fa._use_fused_bwd(t, s) else "split"}
        emit({"phase": "bwd_routes", **row})
        rows.append(row)
        del args
    torch.cuda.empty_cache()
    return rows


def train_config(size, remat_policy, **over):
    """bench.py's training configuration: the named size at full width,
    vocab 32128, bf16 compute, remat on with ``remat_policy``."""
    base = llama.llama2_size(size)
    return llama.LlamaConfig(**{**base.__dict__, "vocab_size": 32128,
                                "max_seq_len": 2048, "dtype": "bfloat16",
                                "remat": True, "remat_policy": remat_policy,
                                **over})


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def train_setup(cfg, batch, seq):
    """bench.py's bench_train on the port: f32 masters, fused AdamW with
    bf16 moments, bf16 gradients, one fixed seeded batch. Returns (state,
    step, batch)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 200)
    opt = train.fused_adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16,
                            nu_dtype=torch.bfloat16)
    state = train.init_train_state(
        lambda dev: llama.init_params(cfg, g, dev, master=True), opt,
        device="cuda")
    step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                                 compute_grad_norm=False,
                                 grads_dtype=torch.bfloat16, device="cuda")
    toks = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int64)
    toks = torch.from_numpy(toks).cuda()
    return state, step, {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def phase_train(tag, cfg, batch, seq, expect, peaks, *, warm=2, timed=5):
    """`warm` train steps, then `timed` steps between CUDA events (see
    train_setup). Every step must launch exactly `expect` flash kernels.
    Returns the launches of all steps."""
    state, step, data = train_setup(cfg, batch, seq)
    per_step, losses, total = [], [], {}

    def one():
        nonlocal state
        fa.reset_launch_count()
        state, metrics = step(state, data)
        counts = fa.launch_counts()
        per_step.append(counts)
        add_counts(total, counts)
        losses.append(metrics["loss"])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(warm):
        one()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        one()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / timed
    with torch.no_grad():
        fa.reset_launch_count()
        final = float(llama.loss_fn(state.params, data, cfg)[0])
        add_counts(total, fa.launch_counts())
    losses = [float(x) for x in losses]
    n_params = cfg.num_params()
    tps = batch * seq / (step_ms / 1e3)
    bad_counts = [c for c in per_step if c != expect]
    ok = (all(np.isfinite(losses)) and np.isfinite(final)
          and final < losses[0] and not bad_counts)
    emit({"phase": tag, "size": f"{cfg.d_model}d x {cfg.n_layers}L",
          "n_params": n_params, "batch": batch, "seq": seq,
          "remat_policy": cfg.remat_policy, "grads_dtype": "bfloat16",
          "warm_steps": warm, "warm_seconds": warm_s, "timed_steps": timed,
          "step_ms": step_ms, "tokens_per_sec": tps,
          "mfu": 6.0 * n_params * tps / peaks[0],
          "mfu_peak_flops": peaks[0], "card": torch.cuda.get_device_name(0),
          "losses": losses, "loss_after_last_step": final,
          "launches_per_step": per_step[-1], "expected_per_step": expect,
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{tag}: losses {losses} -> {final}, launch "
                             f"counts off the expected {expect}: {bad_counts}")
    del state, step
    torch.cuda.empty_cache()
    return total


def phase_sr_card_vs_cpu():
    """The optimizer's stochastic rounding (wrapping int32 tensor ops)
    gives the same bits on the card as on the CPU, where the tests hold
    it bit for bit against the JAX package."""
    from ray_tpu_torch.train.optim import _stochastic_round_bf16

    g = torch.Generator().manual_seed(SEED + 500)
    x = torch.randn(1 << 20, generator=g) * 1e-3
    x[:4] = torch.tensor([float("inf"), -float("inf"), 0.0, -1e-30])
    mismatches = 0
    for key in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        cpu = _stochastic_round_bf16(x, key).view(torch.int16)
        card = _stochastic_round_bf16(x.cuda(), key).view(torch.int16).cpu()
        mismatches += int((cpu != card).sum())
    emit({"phase": "sr_card_vs_cpu", "elements": x.numel(), "keys": 4,
          "mismatches": mismatches, "ok": mismatches == 0})
    if mismatches:
        raise AssertionError(f"stochastic rounding differs on the card: "
                             f"{mismatches} elements")


KERNEL_GROUPS = (("flash", ("flash_",)),
                 ("matmul", ("nvjet", "gemm", "cutlass", "sm90_xmma", "cublas")),
                 ("copy_cast", ("copy", "Memcpy", "Memset")),
                 ("reduce", ("reduce",)),
                 ("elementwise", ("elementwise", "index", "arange", "cat")))


def kernel_group(name):
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def phase_profile(tag, cfg, batch, seq, steps=2):
    """Where a training step's time goes: torch.profiler over `steps`
    steps after one warm step, per step: the device's busy time (the
    union of its kernels' intervals), the wall time with and without the
    profiler, the idle share (busy time against the wall time without
    the profiler, whose own overhead stretches the profiled wall), the
    device spans of the step's two ranges, kernel time by group and the
    top kernels. Before it, the host's time to enqueue a step without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    state, step, data = train_setup(cfg, batch, seq)
    state, _ = step(state, data)
    torch.cuda.synchronize()
    # without the profiler: the host's time to enqueue a step, and the
    # step's wall time (equal when the host holds the device back)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, data)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device kernels: busy time is the union of their intervals
    gpu = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    # the step's ranges also show on the device timeline, as spans
    ranges = {}
    for e in gpu:
        if e.name.startswith("train_step."):
            ranges[e.name] = ranges.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / steps
    kernels = [e for e in gpu if not e.name.startswith("train_step.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 / steps
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3 / steps
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us / 1e3 / steps, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    emit({"phase": tag, "remat_policy": cfg.remat_policy if cfg.remat else None,
          "batch": batch, "seq": seq, "steps": steps,
          "host_enqueue_ms_per_step": enqueue_ms,
          "wall_ms_per_step_unprofiled": plain_wall_ms,
          "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / plain_wall_ms),
          "kernel_ms_per_step_by_group": by_group,
          "range_device_span_ms_per_step": ranges,
          "top_kernels": [{"name": n[:90], "ms_per_step": ms,
                           "calls_per_step": c / steps}
                          for n, (ms, c) in top]})
    del state, step, prof
    torch.cuda.empty_cache()


def phase_grad_exactness_f32():
    """Every gradient with the flash kernels (f32 forward and fused
    backward) against the reference attention under autograd: 350m
    width, 2 layers, f32 compute, TF32 off, B=2 x T=512."""
    cfg = train_config("350m", "dots", n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED + 300)
    params = llama.init_params(cfg, g, "cuda", master=True)
    toks = torch.from_numpy(np.random.RandomState(SEED + 300).randint(
        0, cfg.vocab_size, (2, 513)).astype(np.int64)).cuda()

    def grads(use_flash):
        c = llama.LlamaConfig(**{**cfg.__dict__, "use_flash": use_flash})
        leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(params)]
        loss, _ = llama.loss_fn(tree_unflatten(params, leaves),
                                {"tokens": toks}, c)
        return torch.autograd.grad(loss, leaves)

    fa.reset_launch_count()
    got = grads(True)
    counts = fa.launch_counts()
    want = grads(False)
    # f32 on both sides: only the order of sums differs (and dq's atomics)
    rel_tol = 1e-4
    rel = {p: ((a - w).norm() / w.norm().clamp_min(1e-30)).item()
           for p, a, w in zip(tree_paths(params), got, want)}
    ok = (max(rel.values()) <= rel_tol and counts["flash_bwd_fused"] == 2
          and counts["flash_fwd"] >= 2)
    emit({"phase": "grad_exactness_f32", "layers": 2, "batch": 2, "seq": 512,
          "launches": counts, "rel_l2_err_by_param": rel, "rel_tol": rel_tol,
          "ok": ok})
    if not ok:
        raise AssertionError(f"f32 gradients with the kernels differ: {rel}, "
                             f"launches {counts}")
    del params, got, want
    torch.cuda.empty_cache()


def sdpa_bwd_ms(q, k, v, do):
    """The library's backward alone: scaled_dot_product_attention forward
    + backward minus its forward, on the same inputs (timed only)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qs, ks, vs), do)

    both, only_fwd = time_ms(fwd_bwd), time_ms(fwd)
    return both - only_fwd, both, only_fwd


def run_entry(entry, args, causal=True):
    """Launch the dq or dkv C entry point `entry` on `args` (q, k, v, do,
    lse, delta) directly: the wrappers route bf16 at D=128 to the Hopper
    kernels, so this is how the mma.sync kernels they replaced are timed
    at the same shapes. Returns the outputs."""
    q, k = args[0], args[1]
    outs = ([torch.empty_like(q)] if entry.startswith("flash_bwd_dq")
            else [torch.empty_like(k), torch.empty_like(k)])
    fa._call(entry, [*args, *outs, *fa._dims(q, k, causal, entry)],
             fa._shape_note(q, k))
    return outs


def time_kernel(entry, shape, peaks, seed, plain_iters=5, replaced=None):
    """C entry point `entry` at `shape` (B, Hq, Hkv, T, S, D; bf16, causal),
    through its wrapper, in turns plain, kernel, kernel, plain, library;
    with its error against the plain version there, held to TOL / BWD_TOL,
    and its bound. `replaced`: the entry point of the kernel that `entry`
    replaced, held to the same tolerance and timed in turns with it
    (kernel, replaced, replaced, kernel)."""
    b, hq, hkv, t, s, d = shape
    dtype = torch.bfloat16
    kernel = entry.removesuffix("_sm90")  # the wrapper's name
    if kernel == "flash_fwd":
        q, k, v = flash_inputs(b, hq, hkv, t, s, d, dtype, seed)
        fa.reset_launch_count()
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        launched_only(entry, fa.launch_counts())
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True)
        err = max((out.float() - ref_out.float()).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        tol = TOL[dtype]
        if not (torch.allclose(out.float(), ref_out.float(), atol=tol["out"],
                               rtol=tol["out"])
                and torch.allclose(lse, ref_lse, atol=tol["lse"], rtol=0)):
            raise AssertionError(f"flash_fwd disagrees with its plain version "
                                 f"at {shape}: {err} (tol {tol})")
        del out, lse, ref_out, ref_lse
        run = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
        run_plain = lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True)  # noqa: E731
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_run = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        lib = {"library_ms": time_ms(lib_run), "library_graph_ms": graph_ms(lib_run)}
    else:
        args = bwd_inputs(b, hq, hkv, t, s, d, dtype, True, seed)
        errs, got = bwd_errors(kernel, args, True)
        del got
        err = max(e for e, _ in errs.values())
        if any(rel > BWD_TOL[dtype] for _, rel in errs.values()):
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {shape}: {errs} (tol {BWD_TOL[dtype]})")
        fn, plain, _ = BWD_KERNELS[kernel]
        run = lambda: fn(*args, causal=True)  # noqa: E731
        run_plain = lambda: plain(*args, causal=True)  # noqa: E731
        lib = None
    plain_a = time_ms(run_plain, iters=plain_iters, warmup=1)
    old = None
    if replaced is None:
        kern_a, kern_b = time_ms(run), time_ms(run)
    else:
        want = run_plain()
        old_errs = output_errors(replaced, BWD_KERNELS[kernel][2], run_entry(replaced, args),
                                 want if isinstance(want, tuple) else (want,))
        if any(rel > BWD_TOL[dtype] for _, rel in old_errs.values()):
            raise AssertionError(f"{replaced} disagrees with its plain version at "
                                 f"{shape}: {old_errs} (tol {BWD_TOL[dtype]})")
        del want
        run_old = lambda: run_entry(replaced, args)  # noqa: E731
        kern_a = time_ms(run)
        old_a, old_b = time_ms(run_old), time_ms(run_old)
        kern_b = time_ms(run)
        old = {"name": replaced, "ms": min(old_a, old_b), "ms_runs": [old_a, old_b],
               "graph_ms": graph_ms(run_old),
               "max_abs_err": max(e for e, _ in old_errs.values())}
    kern_graph = graph_ms(run)
    plain_b = time_ms(run_plain, iters=plain_iters, warmup=1)
    if lib is None:
        q, k, v, do = args[:4]
        lib_ms, both, only_fwd = sdpa_bwd_ms(q, k, v, do)
        lib = {"library_ms": lib_ms, "library_fwd_bwd_ms": both,
               "library_fwd_ms": only_fwd}
    bound_ms, bound_by, flops, nbytes = flash_bound(
        b, hq, hkv, t, s, d, True, dtype, peaks, kernel)
    ms = min(kern_a, kern_b)
    row = {"kernel": entry, "shape": dict(B=b, Hq=hq, Hkv=hkv, T=t, S=s, D=d),
           "kernel_ms": [kern_a, kern_b], "kernel_graph_ms": kern_graph,
           "plain_ms": [plain_a, plain_b],
           **lib, "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by, "achieved_tflops": flops / (ms / 1e3) / 1e12,
           "share_of_bound": bound_ms / ms, "max_abs_err": err}
    if old is not None:
        row["replaced"] = {**old, "share_of_bound": bound_ms / old["ms"]}
        row["speedup_over_replaced"] = old["ms"] / ms
    emit({"phase": "kernel_timing", **row})
    torch.cuda.empty_cache()
    return row


# the C entry points the main paths launch (all at bf16, D=128)
SOURCES = {
    "flash_fwd_sm90": ("ray_tpu_torch/csrc/flash_fwd_sm90.cu",
                       "ray_tpu/ops/flash_attention.py:294"),
    "flash_bwd_fused_sm90": ("ray_tpu_torch/csrc/flash_bwd_sm90.cu",
                             "ray_tpu/ops/flash_attention.py:575"),
    "flash_bwd_dq_sm90": ("ray_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                          "ray_tpu/ops/flash_attention.py:678"),
    "flash_bwd_dkv_sm90": ("ray_tpu_torch/csrc/flash_bwd_sm90.cu",
                           "ray_tpu/ops/flash_attention.py:707"),
}
# the Hopper entry point -> the mma.sync kernel (csrc/flash_bwd.cu) it
# replaced on the main path, timed beside it in the kernels line
REPLACED = {"flash_bwd_dq_sm90": "flash_bwd_dq", "flash_bwd_dkv_sm90": "flash_bwd_dkv"}
# main-path shapes (B, Hq, Hkv, T, S, D): the forward's 1B scoring shape
# (and its 350m training shape), the fused backward's 350m training
# shape, and the dq/dkv kernels' at 350m width with T = S = 16384
MAIN_SHAPES = {
    "flash_fwd_sm90": (2, 16, 8, 2048, 2048, 128),
    "flash_bwd_fused_sm90": (8, 8, 8, 2048, 2048, 128),
    "flash_bwd_dq_sm90": (1, 8, 8, 16384, 16384, 128),
    "flash_bwd_dkv_sm90": (1, 8, 8, 16384, 16384, 128),
}


def phase_kernels_line(launches, peaks, build_info):
    """One entry per main-path kernel: its launches on the main paths, its
    time, error, bound, plain and library times, share of bound, and
    ptxas's registers (and the shared memory of the Hopper kernels); for
    dq and dkv, the mma.sync kernel each replaced, timed in turns with it."""
    kernels = []
    for i, (kernel, shape) in enumerate(MAIN_SHAPES.items()):
        row = time_kernel(kernel, shape, peaks, SEED + 400 + i,
                          plain_iters=2 if shape[3] > 4096 else 5,
                          replaced=REPLACED.get(kernel))
        src, replaces = SOURCES[kernel]
        entry = {"name": kernel, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches.get(kernel, 0),
                 "max_abs_err": row["max_abs_err"], "ms": min(row["kernel_ms"]),
                 "plain_ms": min(row["plain_ms"]), "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                 "share_of_bound": row["share_of_bound"], "shape": row["shape"],
                 "graph_ms": row["kernel_graph_ms"], **build_info[kernel]}
        if "library_graph_ms" in row:
            entry["library_graph_ms"] = row["library_graph_ms"]
        if "replaced" in row:
            entry["replaced"] = {**row["replaced"], "source": "ray_tpu_torch/csrc/flash_bwd.cu",
                                 **build_info[row["replaced"]["name"]]}
            entry["speedup_over_replaced"] = row["speedup_over_replaced"]
        if kernel == "flash_fwd_sm90":
            train_row = time_kernel(kernel, MAIN_SHAPES["flash_bwd_fused_sm90"],
                                    peaks, SEED + 410)
            entry["train_350m"] = {k: train_row[k] for k in (
                "shape", "kernel_ms", "kernel_graph_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_graph_ms", "share_of_bound",
                "max_abs_err")}
        kernels.append(entry)
    return kernels


def expected(**launches):
    """Launches per step by entry point: those named, 0 for the rest."""
    return {**{k: 0 for k in fa.launch_counts()}, **launches}


def main() -> None:
    t_start = time.perf_counter()
    name, smi, peaks = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 checks are full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    build_info = phase_build()
    phase_kernel_vs_plain()
    phase_bwd_kernel_vs_plain()
    phase_bwd_determinism()
    phase_bwd_routes()
    cfg = bench_1b_config()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(cfg, g, device="cuda")
    emit({"phase": "init_1b", "n_params": cfg.num_params(),
          "layers": cfg.n_layers, "d_model": cfg.d_model})
    # each main path: counts set to 0 just before it, read just after
    by_path = {}
    with torch.inference_mode():
        by_path["scoring_1b"] = phase_scoring(cfg, params)
        by_path["serving_1b"] = phase_serving(cfg, params)
        del params
        torch.cuda.empty_cache()
        phase_exactness_f32()
    n350 = llama.llama2_size("350m").n_layers
    n1b = llama.llama2_size("1b").n_layers
    by_path["train_350m"] = phase_train(
        "train_350m", train_config("350m", "dots_flash_qkv_mlp"), 8, 2048,
        expected(flash_fwd_sm90=n350, flash_bwd_fused_sm90=n350), peaks)
    by_path["train_1b"] = phase_train(
        "train_1b", train_config("1b", "flash_qkv"), 2, 2048,
        expected(flash_fwd_sm90=n1b, flash_bwd_fused_sm90=n1b), peaks)
    long_cfg = train_config("350m", "dots_flash_qkv_mlp", n_layers=2,
                            max_seq_len=16384)
    by_path["train_long_context"] = phase_train(
        "train_long_context", long_cfg, 1, 16384,
        expected(flash_fwd_sm90=2, flash_bwd_dq_sm90=2, flash_bwd_dkv_sm90=2), peaks)
    phase_grad_exactness_f32()
    phase_sr_card_vs_cpu()
    phase_profile("profile_train_350m", train_config("350m", "dots_flash_qkv_mlp"),
                  8, 2048)
    phase_profile("profile_train_long_context", long_cfg, 1, 16384, steps=5)
    launches = {}
    for counts in by_path.values():
        add_counts(launches, counts)
    for kernel in SOURCES:
        if launches.get(kernel, 0) == 0:
            raise AssertionError(f"{kernel} was launched no time on the main "
                                 f"paths: {by_path}")
    emit({"phase": "launches_by_path", **by_path})
    kernels = phase_kernels_line(launches, peaks, build_info)
    emit({"phase": "memory",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
          "script_seconds": time.perf_counter() - t_start})
    print(smi.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
