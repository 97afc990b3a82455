"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases trainer,mesh   # only these groups


Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain torch version on the card, drives the inference
path at the full width and depth of Llama-1B (a scoring forward through
the flash kernel, then the continuous-batching engine serving 32
requests, whose outputs are scored again), then every other kind of
request the engine serves: sampled lanes (whose threefry bits must equal
the CPU's, whose replays must equal bit for bit, and whose behaviour
logprobs are set beside a teacher-forced forward), speculative decoding,
the prefix cache and disaggregated prefill, then the serving wrappers
(LLMServer's pump thread answering the same 32 requests from 16 handler
threads, by generate() and by streaming, through a live weight swap, and
a PrefillWorker's KV handed to it: tokens/s, time to first token and time
between tokens from the per-token stamps), then the serving pool
(LLMPool over two such replicas: the same traffic, a replica killed under
greedy and sampled streams, a weight publish with disaggregated prefill,
and a burst that autoscales it from one replica to two and back), the
same pool with each replica a process of its own (ProcessRuntime: the
traffic, a publish to both processes, a replica killed by SIGKILL and
its device memory back), with
an f32 2-layer copy
holding each engine path to the one it must reproduce. Then the
mixture-of-experts model at the 1B widths with 8 experts, top-2
(capacity routing at factor 1.25): scoring, the engine greedy and
sampled (a sampled run replayed bit for bit), one capacity-routed layer
on the card against the CPU, the engine paths of an f32 2-layer copy
with dense dispatch, and LLMServer("moe-tiny"); and an 8-layer training
step of it. Then the
training path: Llama-350m at B=8 x T=2048 and Llama-1B at B=2 x T=2048,
both at full width and depth (bench.py's headline configurations), a
2-layer 350m-width step at T=16384 that takes the dq + dkv backward
kernels, and an f32 check of every gradient against the reference
attention. Then the mesh path in a world of one rank (NCCL): the
multi-device dry run, the Llama-1B step through the mesh forms of the
train step (every leaf and activation a DTensor) held to the one-device
step, ring and Ulysses attention at sp = 1, and the GPipe pipeline at pp
= 1 over the 1B layer stack held to the plain layer loop. Then the
pipeline slice's path: Llama-1B as a two-stage MPMD pipeline (a thread
and a CUDA stream per stage, 1F1B, 4 microbatches of B1 x T2048, 3 SGD
steps) held to the sequential one-device run of the same steps. Then
the train runtime's path: a Trainer of two data-parallel workers (threads
with a CUDA stream each) running the Llama-1B step, gradients averaged
through the host every step, rank 0 saving the train state after step 2,
worker 1 killed in step 3 and resumed in place from that checkpoint,
held to the same run without the fault. Then the RL layer: the
learners' updates (PPO, IMPALA, APPO, BC) and the vision module on the
card held to the CPU, the port's PPO on a corridor env, and the
actor-learner loop at Llama-1B (rollout threads streaming sampled
requests through a one-replica LLMPool, a learner of Trainer(backend=
"dcn") scoring them through the flash forward and backward, its
weights published back each iteration), with its buffer's conservation
and the learner's logprobs against the engine's at lag 0, then one
iteration of it with the replica and the buffer in processes of their
own. Then
off-policy RL: DQN's and SAC's updates on the card against the CPU, the
learner groups (two members on the card, gradients allreduced through
the in-process runtime) against the single learner, PPO with two
learners, DQN learning the corridor, SAC on the pendulum, and the policy
server on the card behind the in-process HTTP ingress; run_llm_pool at
1B answers requests over HTTP (with the serving phases), and the
trainer's 9.36 GB checkpoint is shipped through the in-process store and
fetched back (with the trainer phase). Then the runtime benchmark
families that run model code (ray_tpu_torch._private.runtime_perf, quick):
weight publish and the KV handoff, pool decode at 1 and 2 replicas and
with the prefix cache, speculation off and at depth 2 and 4, the RL
rollout, experience handoff and publish, and the 2-stage numpy MPMD
pipeline, over the in-process runtimes, each held to the correctness
contract of the JAX module's committed floors, and the serve family
again with each member in a process of its own. Every
bf16 head_dim-128
flash call on those paths must go
through the Hopper kernels (flash_fwd_sm90, flash_bwd_fused_sm90, and
past 8192 keys flash_bwd_dq_sm90 + flash_bwd_dkv_sm90), which the launch
counts by entry point show. It checks the results and prints one JSON
line per phase. The line before the last lists every main-path kernel
with its launches on the main paths, error, time (eager, and replayed
from a CUDA graph), the plain version's time, the library call's time,
the card's bound, its share of that bound and ptxas's registers; the
last line is {"ok": true, "device": {...}}. Any failure raises: the exit
code is then non-zero and no result line is printed. Needs one CUDA
device. With --phases it runs the device and build phases and then only
the named groups of GROUPS (or the groups of the named phases), and
prints no kernels line.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import _kernels, multichip, train
from ray_tpu_torch._private import runtime_perf
from ray_tpu_torch.models import decode_engine, kv_prefix_cache, llama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import ring_attention, ulysses
from ray_tpu_torch.ops.losses import softmax_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rotary_embedding
from ray_tpu_torch.parallel import (MpmdPipeline, StageSpec, launch,
                                    pipeline_apply, pipeline_stages)
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh, use_mesh
from ray_tpu_torch.parallel.pipeline_runtime import InProcessPipelineRuntime
from ray_tpu_torch.rl import (actor_learner, appo, bc, dqn, envs, impala,
                              learner_group, policy_server, ppo, replay,
                              rl_module, sac)
from ray_tpu_torch.rl import learner as rl_learner
from ray_tpu_torch.train import checkpoint as ckpt_mod
from ray_tpu_torch.train import dcn, fault_injection
from ray_tpu_torch.train.worker_group import InProcessTrainRuntime
from ray_tpu_torch.serve import llm as serve_llm
from ray_tpu_torch.serve import llm_pool, process_runtime
from ray_tpu_torch.serve import runtime as serve_runtime
from ray_tpu_torch.utils import prng
from ray_tpu_torch.utils.trees import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)

SEED = 0
# Datasheet peaks (dense): bf16 tensor-core FLOP/s and HBM bytes/s.
PEAKS = {"sxm": (989e12, 3.35e12), "pcie": (756e12, 2.0e12)}
# Kernel-vs-plain tolerances. bf16: p is rounded to bf16 before P.V on
# both sides, and an f32 exp that differs in its last bit can round to
# the neighbouring bf16 value; lse sums f32 terms in another order. f32:
# both sides run full f32 (TF32 off, set below).
TOL = {torch.bfloat16: dict(out=2e-2, lse=1e-3),
       torch.float32: dict(out=1e-4, lse=1e-4)}
# (name, B, Hq, Hkv, T, S, D, causal, dtype); the first five are the
# main paths' (1B scoring, 350m training, long-context training, the 1B
# pipelines' microbatch of one row, the RL learner's batch of 8
# trajectories of 64 + 64 tokens). bf16 at
# D=128 takes flash_fwd_sm90 (the edges of its 128-row q tiles and
# 128-key tiles below), the rest flash_fwd.
FLASH_CASES = [
    ("main_1b", 2, 16, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("main_350m_train", 8, 8, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("long_ctx_350m", 1, 8, 8, 16384, 16384, 128, True, torch.bfloat16),
    ("pipeline_1b", 1, 16, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("rl_1b", 8, 16, 8, 128, 128, 128, True, torch.bfloat16),
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
    ("pipeline_1b", 1, 16, 8, 2048, 2048, 128, True, torch.bfloat16, "fused"),
    ("rl_1b", 8, 16, 8, 128, 128, 128, True, torch.bfloat16, "fused"),
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
# that returns its shared memory): the ones a main path takes at bf16 D=128
KERNEL_SYMBOLS = {
    "flash_fwd_sm90": ("flash_fwd_sm90_kernel", "flash_fwd_sm90_smem_bytes"),
    "flash_bwd_fused_sm90": ("flash_bwd_sm90_kernelILb1E",
                             "flash_bwd_fused_sm90_smem_bytes"),
    "flash_bwd_dq_sm90": ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_sm90_smem_bytes"),
    "flash_bwd_dkv_sm90": ("flash_bwd_sm90_kernelILb0E", "flash_bwd_dkv_sm90_smem_bytes"),
}
# the Hopper kernels: ptxas must report no spills for them
NEW_KERNELS = ("flash_fwd_sm90", "flash_bwd_fused_sm90", "flash_bwd_dq_sm90",
               "flash_bwd_dkv_sm90")


# requests of 128 new tokens on the 1B serving paths: two waves of the
# 8 slots (32 before, four waves; halved to keep the whole run
# inside its time limit), but for the greedy engine and LLMServer, which
# keep 32: the server's live weight swap needs requests that its 16
# handler threads submit after the swap has landed
SERVING_REQUESTS = 16
SERVER_REQUESTS = 32
# one wave of the 8 slots for the speculative and the MoE engine phases
# (they served 16, and 32 before that), to make room for the RL group in
# the time limit; every check of theirs holds over these 8
SHORT_REQUESTS = 8
RECORDS = {}  # the last line emitted by each phase
T_IMPORT = T_LAST = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also records when it was
    printed (at_s: seconds since this module was imported) and the
    seconds since the line before it (phase_s: the phase's own seconds,
    for a phase that prints one line)."""
    global T_LAST
    if "phase" in obj:
        now = time.perf_counter()
        obj["at_s"] = round(now - T_IMPORT, 1)
        obj["phase_s"] = round(now - T_LAST, 1)
        T_LAST = now
        RECORDS[obj["phase"]] = obj
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
    prompt_len, new_tokens, n_requests, slots = 128, 128, SERVER_REQUESTS, 8
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
    return fa.launch_counts(), [s.tokens for s in streams]


def exactness_prompts():
    """The f32 checks' 12 prompts of 40 to 128 tokens."""
    rng = np.random.RandomState(SEED + 1)
    return [rng.randint(1, 30000, int(n)).astype(np.int32)
            for n in rng.randint(40, 129, 12)]


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
    prompts = exactness_prompts()
    new_tokens = 32
    sids = [eng.submit(p, new_tokens) for p in prompts]
    eng.drain()
    mismatched, greedy = [], []
    for sid, p in zip(sids, prompts):
        s = eng.pop_finished(sid)
        ref = llama.greedy_generate(params, torch.from_numpy(p[None]).cuda(),
                                    cfg, new_tokens)[0, len(p):].tolist()
        if s.tokens != ref:
            mismatched.append(sid)
        greedy.append(s.tokens)
    emit({"phase": "exactness_f32_2layer", "streams": len(prompts),
          "new_tokens": new_tokens, "mismatched_streams": mismatched,
          "ok": not mismatched})
    if mismatched:
        raise AssertionError(f"engine != greedy_generate on {mismatched}")
    exactness_f32_engine_paths(cfg, params, prompts, greedy, new_tokens)
    del params, eng
    torch.cuda.empty_cache()


# -- the engine's sampled, speculative, prefix-cache and disaggregated
# paths --

# f32: a divergence whose margin is under this is a near-tie (torch's and
# cuBLAS's roundings at other product shapes move scores by ~1e-6)
NEAR_TIE_TOL = 1e-4
SAMPLED = dict(temperature=0.8, top_p=0.95)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gave them."""
    return RECORDS["device"]["nvidia_smi"].splitlines()[0]


def token_divergence(got, want, scores):
    """First position where two token sequences differ, and the margin
    there: `scores(i)` is the f32 score vector whose argmax picks token i
    (logits for a greedy row, filtered logits plus Gumbel noise for a
    sampled one); the margin is its best score minus the lower of the two
    chosen tokens' scores. (None, None) for equal sequences."""
    got, want = [int(x) for x in got], [int(x) for x in want]
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            s = scores(i).double()
            return i, float(s.max() - torch.minimum(s[a], s[b]))
    if len(got) != len(want):
        raise AssertionError(f"sequences of {len(got)} and {len(want)} tokens")
    return None, None


def assert_tokens_agree(got, want, scores, tol=NEAR_TIE_TOL):
    """The near-tie rule: equal sequences, or a first divergence whose
    margin is under `tol`. Returns (position, margin) or (None, None)."""
    i, margin = token_divergence(got, want, scores)
    if i is not None and not margin < tol:
        raise AssertionError(f"tokens diverge at {i} with margin {margin} "
                             f">= {tol}: not a near-tie")
    return i, margin


def stream_scores(params, cfg, prompt, tokens, seed=0, temperature=0.0,
                  top_p=1.0):
    """scores(i) for token_divergence: the teacher-forced logits after
    prompt + tokens[:i] (llama.forward), through the stream's lane."""
    def scores(i):
        seq = np.concatenate([prompt, np.asarray(tokens[:i], np.int32)])
        logits = llama.forward(params, torch.from_numpy(seq[None]).cuda(),
                               cfg)[0, -1:].float()
        lane = [torch.tensor([x], device="cuda")
                for x in (seed, len(seq) - 1, float(temperature), float(top_p))]
        return decode_engine.sample_scores(logits, *lane)[0][0]
    return scores


def agreement(params, cfg, prompts, got, want, lanes):
    """Two runs' tokens, stream by stream: the share of positions that
    hold the same token, the share of tokens before each stream's first
    divergence, and every first divergence with its margin."""
    same = before = total = 0
    divergences = []
    for j, (p, a, b) in enumerate(zip(prompts, got, want)):
        total += len(b)
        same += sum(int(x) == int(y) for x, y in zip(a, b))
        i, margin = token_divergence(a, b, stream_scores(params, cfg, p, a,
                                                         **lanes[j]))
        before += len(b) if i is None else i
        if i is not None:
            # an infinite margin: one side's token lies outside the other
            # side's top-p nucleus (a divergence at the nucleus boundary)
            divergences.append({"stream": j, "at": i, "margin": margin
                                if np.isfinite(margin) else "outside_nucleus"})
    return {"equal_token_share": same / total,
            "share_before_first_divergence": before / total,
            "streams_equal": len(prompts) - len(divergences),
            "divergences": divergences}


def serving_requests(n: int = SERVING_REQUESTS):
    """phase_serving's requests, from the same seeded stream: its warm-up
    prompt and the first n of its prompts of 128 tokens."""
    rng = np.random.RandomState(SEED)
    warm = rng.randint(1, 30000, 128).astype(np.int32)
    return warm, [rng.randint(1, 30000, 128).astype(np.int32)
                  for _ in range(n)]


def serving_engine(cfg, params, **kw):
    """phase_serving's engine: 8 slots of 288 rows, chunks of 32 steps."""
    return decode_engine.RaggedDecoder(
        params, cfg, **{"slots": 8, "max_len": 288, "chunk_tokens": 32,
                        "prompt_buckets": (128,), "device": "cuda", **kw})


def serve(eng, prompts, new_tokens, lanes, kvs=None, pumps=None):
    """Submit every prompt on its lane (pre-filled when `kvs` is given),
    pump until drained, pop. Returns (streams, seconds of the drain ended
    by a device sync); raises unless every stream finished with
    `new_tokens`. `pumps`, a list, gets (seconds, streams admitted) per
    pump: each pump ends in its one device->host transfer, so its time is
    the device's too, and a pump delivers the first tokens of the streams
    it admits."""
    if kvs is None:
        sids = [eng.submit(p, new_tokens, **lane)
                for p, lane in zip(prompts, lanes)]
    else:
        sids = [eng.submit_prefilled(p, new_tokens, kv, **lane)
                for p, kv, lane in zip(prompts, kvs, lanes)]
    pumps = [] if pumps is None else pumps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slot_stream):
        queued, tp = len(eng.queue), time.perf_counter()
        eng.pump()
        pumps.append((time.perf_counter() - tp, queued - len(eng.queue)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    streams = [eng.pop_finished(sid) for sid in sids]
    lens = [len(s.tokens) if s is not None else 0 for s in streams]
    if lens != [new_tokens] * len(prompts):
        raise AssertionError(f"streams did not all finish with {new_tokens} "
                             f"tokens: {lens}")
    return streams, dt


def pump_times(pumps):
    """Pump times of a drain: the first (the first wave's time to first
    token, its prefill and one chunk), and the mean of the pumps that
    admitted streams and of those that only decoded."""
    admitting = [t for t, n in pumps if n > 0]
    decoding = [t for t, n in pumps if n == 0]
    return {"pumps": len(pumps), "first_pump_s": pumps[0][0],
            "admitting_pump_s": float(np.mean(admitting)) if admitting else None,
            "decode_only_pump_s": float(np.mean(decoding)) if decoding else None}


def bits_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.int32),
                          np.asarray(b, np.float32).view(np.int32))


def card_launches(fn) -> int:
    """Device kernels (and copies) one call of `fn` launches, counted by
    torch.profiler after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def decode_step_launches(cfg, params):
    """Launches of one decode step of the 8-slot batch, greedy and sampled,
    and of the sampler alone (the engine's host-bound cost)."""
    cache = decode_engine.init_ragged_cache(cfg, 8, 288, "cuda")
    tok = torch.ones(8, dtype=torch.int32, device="cuda")
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    seeds = torch.arange(8, device="cuda")
    pos = torch.full((8,), 200, dtype=torch.int32, device="cuda")
    temps = torch.full((8,), SAMPLED["temperature"], device="cuda")
    top_ps = torch.full((8,), SAMPLED["top_p"], device="cuda")
    logits = torch.randn((8, cfg.vocab_size), device="cuda")
    return {
        "greedy_step": card_launches(lambda: decode_engine.decode_chunk(
            params, cache, tok, active, cfg, 1)),
        "sampled_step": card_launches(lambda: decode_engine.decode_chunk_sampled(
            params, cache, tok, active, seeds, temps, top_ps, cfg, 1)),
        "sampler": card_launches(lambda: decode_engine._sample_from_logits(
            logits, seeds, pos, temps, top_ps)),
    }


def phase_prng_card_vs_cpu():
    """The sampling lanes' threefry keys, bits and uniforms on the card
    equal the CPU's bit for bit (where the tests hold them against
    jax.random); the Gumbel noise within 2 ulp, the ulp taken at
    max(|g|, 1)."""
    seeds = np.array([0, 1, 7, 2**31 + 7, 12345, 2**32 - 1, 1000, 2024], np.int64)
    pos = np.array([0, 1, 127, 4095], np.int64)
    seeds, pos = np.repeat(seeds, len(pos)), np.tile(pos, len(seeds))
    shape = (32128,)
    out = {}
    for dev in ("cpu", "cuda"):
        keys = prng.fold_in(prng.prng_key(torch.from_numpy(seeds).to(dev)),
                            torch.from_numpy(pos).to(dev))
        out[dev] = [x.cpu() for x in (keys, prng.random_bits(keys, shape),
                                      prng.uniform(keys, shape),
                                      prng.gumbel(keys, shape))]
    exact = {name: bool(torch.equal(a, b)) for name, a, b in zip(
        ("keys", "bits", "uniform"), out["cpu"][:3], out["cuda"][:3])}
    g_cpu, g_card = out["cpu"][3].numpy(), out["cuda"][3].numpy()
    ulp = np.spacing(np.maximum(np.abs(g_cpu), 1.0).astype(np.float32))
    gap = float((np.abs(g_card.astype(np.float64) - g_cpu) / ulp).max())
    ok = all(exact.values()) and gap <= 2.0 and bool(np.isfinite(g_card).all())
    emit({"phase": "prng_card_vs_cpu", "card": card(), "keys": len(seeds),
          "vocab": shape[0],
          "bit_exact": exact, "gumbel_max_gap_ulp": gap,
          "gumbel_max_abs_diff": float(np.abs(g_card - g_cpu).max()), "ok": ok})
    if not ok:
        raise AssertionError(f"the lanes differ on the card: {exact}, "
                             f"gumbel {gap} ulp")


def phase_serving_sampled(cfg, params):
    """phase_serving's requests, sampled (temperature 0.8, top_p 0.95,
    seed 1000 + i). Checks: every stream finishes, logprobs finite and <=
    0, four streams replayed alone give the same tokens and logprobs bit
    for bit (the engine's products keep their shapes: 8 slots, prefill
    width 8), and behaviour logprobs of 8 streams at temperature 1 beside
    the teacher-forced log-softmax of llama.forward, which launches
    flash_fwd_sm90 once a layer. Returns (launches, the streams'
    tokens)."""
    warm, prompts = serving_requests()
    lanes = [dict(SAMPLED, seed=1000 + i) for i in range(len(prompts))]
    eng = serving_engine(cfg, params)
    serve(eng, [warm], 32, lanes[:1])  # untimed
    fa.reset_launch_count()
    pumps = []
    streams, dt = serve(eng, prompts, 128, lanes, pumps=pumps)
    counts = fa.launch_counts()
    lps = np.array([s.logprobs for s in streams], np.float32)
    if not (np.isfinite(lps).all() and (lps <= 0.0).all()):
        raise AssertionError("sampled logprobs not finite and <= 0")
    replayed = {}
    for j in (0, 5, 10, 15):
        (s,), _ = serve(eng, [prompts[j]], 128, [lanes[j]])
        replayed[j] = (s.tokens == streams[j].tokens
                       and bits_equal(s.logprobs, streams[j].logprobs))
    # behaviour logprobs against the teacher-forced forward
    tf_lanes = [dict(temperature=1.0, top_p=1.0, seed=2000 + i) for i in range(8)]
    tf_streams, _ = serve(eng, prompts[:8], 128, tf_lanes)
    seqs = torch.from_numpy(np.stack([
        np.concatenate([p, np.asarray(s.tokens, np.int32)])
        for p, s in zip(prompts[:8], tf_streams)])).cuda()
    fa.reset_launch_count()
    logits = llama.forward(params, seqs, cfg)
    torch.cuda.synchronize()
    score_counts = fa.launch_counts()
    launched_only("flash_fwd_sm90", score_counts)
    lsm = torch.log_softmax(logits[:, 127:-1].float(), dim=-1)
    ref = lsm.gather(-1, seqs[:, 128:, None].long())[..., 0].cpu().numpy()
    gap = np.abs(np.array([s.logprobs for s in tf_streams], np.float32) - ref)
    greedy_tps = RECORDS["serving_1b"]["engine_tokens_per_sec"]
    ok = (all(replayed.values())
          and score_counts["flash_fwd_sm90"] == cfg.n_layers)
    emit({"phase": "serving_1b_sampled", "card": card(), "requests": len(prompts),
          "new_tokens": 128, **SAMPLED, "seeds": "1000 + i", "seconds": dt,
          "engine_tokens_per_sec": len(prompts) * 128 / dt,
          "greedy_engine_tokens_per_sec": greedy_tps, **pump_times(pumps),
          "logprob_min": float(lps.min()), "replayed_alone_bit_exact": replayed,
          "teacher_forced_flash_launches": score_counts["flash_fwd_sm90"],
          "teacher_forced_logprob_gap_median": float(np.median(gap)),
          "teacher_forced_logprob_gap_max": float(gap.max()),
          "launches_per_decode_step": decode_step_launches(cfg, params),
          "stats": eng.stats(), "ok": ok})
    if not ok:
        raise AssertionError(f"sampled serving: replayed {replayed}, scoring "
                             f"launches {score_counts}")
    return add_counts(counts, score_counts), [s.tokens for s in streams]


def phase_serving_spec(cfg, params, plain):
    """The same requests, greedy and then sampled, with spec_depth 4 and the
    default draft (half the layers, no head), beside plain decoding's
    tokens/s and tokens (`plain`: mode -> (tokens/s, tokens)), over the
    first SHORT_REQUESTS requests."""
    warm, prompts = serving_requests(SHORT_REQUESTS)
    counts = {}
    for mode in ("greedy", "sampled"):
        lanes = [dict(SAMPLED, seed=1000 + i) if mode == "sampled" else {}
                 for i in range(len(prompts))]
        serve(serving_engine(cfg, params, spec_depth=4), [warm], 32, lanes[:1])
        eng = serving_engine(cfg, params, spec_depth=4)
        fa.reset_launch_count()
        pumps = []
        streams, dt = serve(eng, prompts, 128, lanes, pumps=pumps)
        add_counts(counts, fa.launch_counts())
        spec = eng.stats()["spec"]
        plain_tps, plain_tokens = plain[mode]
        emit({"phase": "serving_1b_spec", "card": card(), "mode": mode, "seconds": dt,
              "engine_tokens_per_sec": len(prompts) * 128 / dt,
              "plain_engine_tokens_per_sec": plain_tps, **spec,
              **pump_times(pumps),
              "agreement_with_plain": agreement(
                  params, cfg, prompts, [s.tokens for s in streams],
                  plain_tokens, lanes)})
    return counts


def phase_serving_prefix(cfg, params):
    """32 greedy requests of a shared 96-token system prefix and a unique
    32-token tail, 32 new tokens each; block 32, buckets (32, 128); the
    cache off, then on. Hit rate over the timed requests, tokens/s both
    ways, agreement of warm and cold tokens."""
    rng = np.random.RandomState(SEED + 7)
    system = rng.randint(1, 30000, 96).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, 30000, 32).astype(np.int32)])
               for _ in range(32)]
    warm = rng.randint(1, 30000, 128).astype(np.int32)
    lanes = [{}] * len(prompts)
    runs, counts = {}, {}
    for mode in ("off", "on"):
        pc = kv_prefix_cache.PrefixCache(block=32) if mode == "on" else None
        eng = serving_engine(cfg, params, prompt_buckets=(32, 128),
                             prefix_cache=pc)
        serve(eng, [warm], 32, lanes[:1])  # untimed, no shared prefix
        before = pc.stats() if pc else {}
        fa.reset_launch_count()
        pumps = []
        streams, dt = serve(eng, prompts, 32, lanes, pumps=pumps)
        add_counts(counts, fa.launch_counts())
        after = pc.stats() if pc else {}
        runs[mode] = (streams, dt, {k: after[k] - before[k]
                                    for k in ("hits", "misses")} if pc else None,
                      pump_times(pumps))
    hm = runs["on"][2]
    rec = {"phase": "serving_1b_prefix", "card": card(), "requests": len(prompts),
          "prefix_tokens": 96, "tail_tokens": 32, "new_tokens": 32, "block": 32,
          "hits": hm["hits"], "misses": hm["misses"],
          "hit_rate": hm["hits"] / (hm["hits"] + hm["misses"]),
          "engine_tokens_per_sec_cache_on": len(prompts) * 32 / runs["on"][1],
          "engine_tokens_per_sec_cache_off": len(prompts) * 32 / runs["off"][1],
          "pumps_cache_on": runs["on"][3], "pumps_cache_off": runs["off"][3],
          "warm_vs_cold": agreement(params, cfg, prompts,
                                    [s.tokens for s in runs["on"][0]],
                                    [s.tokens for s in runs["off"][0]], lanes)}
    emit(rec)
    # the first wave of 8 misses and fills the cache, 24 hits follow
    if (hm["hits"], hm["misses"]) != (24, 8):
        raise AssertionError(f"prefix cache: {hm['hits']} hits and "
                             f"{hm['misses']} misses, expected 24 and 8")
    return counts


def phase_serving_disaggregated(cfg, params, inline_tokens):
    """The first 8 sampled requests prefilled apart (prefill_kv_sampled),
    their KV taken to the host and adopted through submit_prefilled;
    tokens against the inline admission's (phase_serving_sampled)."""
    _, prompts = serving_requests()
    prompts, n = prompts[:8], 8
    lanes = [dict(SAMPLED, seed=1000 + i) for i in range(n)]
    fa.reset_launch_count()
    t0 = time.perf_counter()
    k, v, tok0, lp0 = decode_engine.prefill_kv_sampled(
        params, torch.from_numpy(np.stack(prompts)).cuda(), [128] * n,
        [x["seed"] for x in lanes], [x["temperature"] for x in lanes],
        [x["top_p"] for x in lanes], cfg, 288)
    k, v, tok0, lp0 = k.cpu(), v.cpu(), tok0.cpu(), lp0.cpu()  # the host hop
    prefill_s = time.perf_counter() - t0
    kvs = [{"k": k[:, i], "v": v[:, i], "first_token": int(tok0[i]),
            "first_logprob": float(lp0[i]), "true_len": 128} for i in range(n)]
    eng = serving_engine(cfg, params)
    streams, dt = serve(eng, prompts, 128, lanes, kvs=kvs)
    counts = fa.launch_counts()
    got = [s.tokens for s in streams]
    equal = sum(a == b for a, b in zip(got, inline_tokens))
    emit({"phase": "serving_1b_disaggregated", "card": card(), "requests": n,
          "kv_bytes_to_host": 2 * k.numel() * k.element_size(),
          "prefill_and_host_hop_seconds": prefill_s, "decode_seconds": dt,
          "bit_equal_streams": equal,
          "agreement_with_inline": agreement(params, cfg, prompts, got,
                                             inline_tokens[:n], lanes)})
    # both sides run the same [8, 128] prefill into the same slots
    if equal != n:
        raise AssertionError(f"disaggregated admission: {equal} of {n} "
                             f"streams equal inline admission's tokens")
    return counts


class PumpErrors(logging.Handler):
    """Collects the port's "decode pump error" records: a server's pump
    thread survives any exception (as a replica must), so a failed kernel
    build or a sticky CUDA error there would only show as a stream that
    never finishes. The serving phase fails on the record instead."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        if record.getMessage() == "decode pump error":
            self.records.append(self.format(record))


def percentiles(xs, unit=1.0):
    return {"p50": unit * float(np.percentile(xs, 50)),
            "p99": unit * float(np.percentile(xs, 99))}


POLL_TICK_S = 0.01  # a consumer polling its streams at RPC pace


def serve_through_server(srv, prompts, new_tokens, on_progress,
                         concurrency=16):
    """phase_serving's requests through the server's entry points from
    `concurrency` handler threads (bench.py's decode_serve_1b): even
    requests by generate(), odd ones by submit_stream() and a poller
    thread that drains every live stream with ONE poll_streams() per tick
    (every POLL_TICK_S), stamping tokens (perf_counter) as they reach it.
    `on_progress(k)` runs on the calling thread when the k-th request
    finishes. Returns (results, seconds, poll ticks, poll RPCs the server
    counted over them, streams polled per tick)."""
    n = len(prompts)
    results = [None] * n
    errors = []
    lock = threading.Lock()
    live = {}  # sid -> (request index, result being filled)
    done = [threading.Event() for _ in range(n)]
    finished = threading.Semaphore(0)
    stop = threading.Event()
    sem = threading.Semaphore(concurrency)
    per_tick = []  # streams polled by each tick

    def one(i):
        try:
            with sem:
                p = prompts[i].tolist()
                if i % 2 == 0:
                    results[i] = srv.generate(p, new_tokens)
                    return
                r = {"tokens": [], "token_times_s": [], "versions": set(),
                     "submitted_s": time.perf_counter()}
                sid = srv.submit_stream({"prompt_ids": p,
                                         "max_tokens": new_tokens})["sid"]
                with lock:
                    live[sid] = (i, r)
                if not done[i].wait(timeout=300):
                    raise TimeoutError(f"stream {i} did not finish")
        except Exception as e:  # noqa: BLE001 — raised on the caller
            errors.append(e)
        finally:
            finished.release()

    def tick():
        with lock:
            sids = list(live)
        if not sids:
            return
        out = srv.poll_streams(sids)
        t = time.perf_counter()
        per_tick.append(len(sids))
        for sid, got in out.items():
            i, r = live[sid]
            r["tokens"] += got["tokens"]
            r["token_times_s"] += [t] * len(got["tokens"])
            if got["version"] is not None:
                r["versions"].add(got["version"])
            if got["done"]:
                (r["weights_version"],) = r.pop("versions")
                results[i] = r
                with lock:
                    del live[sid]
                done[i].set()

    def poller():
        try:
            while not stop.is_set():
                tick()
                time.sleep(POLL_TICK_S)
        except Exception as e:  # noqa: BLE001 — raised on the caller
            errors.append(e)
            for ev in done:
                ev.set()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    polling = threading.Thread(target=poller)
    polls0 = srv.stats()["stream_polls"]
    t0 = time.perf_counter()
    polling.start()
    for th in threads:
        th.start()
    for k in range(n):
        if not finished.acquire(timeout=300):
            raise TimeoutError(f"{n - k} requests did not finish")
        on_progress(k + 1)
    dt = time.perf_counter() - t0
    stop.set()
    for th in threads + [polling]:
        th.join(timeout=60)
        if th.is_alive():
            raise AssertionError("a handler or poller thread did not end")
    if errors:
        raise errors[0]
    return (results, dt, len(per_tick), srv.stats()["stream_polls"] - polls0,
            per_tick)


def phase_serving_server(greedy_tokens):
    """The serving wrappers at Llama-1B: LLMServer (8 slots of 288 rows,
    chunks of 32; weights equal to phase_serving's, the same seeded
    init_params) serves phase_serving's requests from 16 handler
    threads, half by generate() and half streamed; an update_weights to
    the same tree as version 1 is sent once 4 have finished; then four
    streams prefilled by a PrefillWorker are adopted. Raises unless the
    tokens agree with phase_serving's (near-tie rule), every stream is
    stamped once a token, a batched poll tick costs one RPC, streams
    finished before the swap carry version 0 and those admitted after it
    version 1, the adopted streams equal their inline runs bit for bit,
    shutdown drains and ends the pump, and no pump error was logged.
    Reports tokens/s, time to first token and time between tokens
    (bench.py's normalisation: positive stamp gaps over the chunk).
    Returns the path's flash launches: none, the engine attends by a
    masked einsum, as the JAX package's does."""
    warm, prompts = serving_requests(SERVER_REQUESTS)
    new_tokens, chunk = 128, 32
    errors = PumpErrors()
    port_log = logging.getLogger("ray_tpu_torch")
    port_log.addHandler(errors)
    try:
        fa.reset_launch_count()
        srv = serve_llm.LLMServer(
            "1b", slots=8, max_len=288, chunk_tokens=chunk,
            prompt_buckets=(128,), seed=SEED, device="cuda")
        srv.generate(warm.tolist(), 32)  # first prefill + chunk, untimed
        pumps0 = srv.stats()["pumps"]
        swap = {}

        def on_progress(finished):
            if finished != 4:
                return
            swap["sent"] = time.perf_counter()
            srv.update_weights(srv.engine.params, 1)
            deadline = time.monotonic() + 60
            while srv.weights_version() != 1:
                if time.monotonic() > deadline:
                    raise AssertionError("the weight swap never landed")
                time.sleep(0.001)
            swap["landed"] = time.perf_counter()

        results, dt, ticks, poll_rpcs, per_tick = serve_through_server(
            srv, prompts, new_tokens, on_progress)
        pumps = srv.stats()["pumps"] - pumps0
        counts = fa.launch_counts()

        worker = llm_pool.PrefillWorker(
            "1b", max_len=288, prompt_buckets=(128,),
            params_blob=srv.engine.params, device="cuda")
        t0 = time.perf_counter()
        kvs = [worker.prefill(p.tolist()) for p in prompts[:4]]
        prefill_s = time.perf_counter() - t0
        adopted = [None] * 4

        def adopt(j):
            adopted[j] = srv.adopt_prefilled(kvs[j], prompts[j].tolist(),
                                             new_tokens)

        adopters = [threading.Thread(target=adopt, args=(j,))
                    for j in range(4)]
        for th in adopters:
            th.start()
        for th in adopters:
            th.join(timeout=300)
        drained = srv.shutdown(30)
        pump_alive = srv._pump_thread.is_alive()
    finally:
        port_log.removeHandler(errors)

    stamps_ok = all(
        r is not None
        and len(r["tokens"]) == len(r["token_times_s"]) == new_tokens
        and r["submitted_s"] <= r["token_times_s"][0]
        and all(b >= a for a, b in zip(r["token_times_s"],
                                       r["token_times_s"][1:]))
        for r in results + adopted)
    ttft = [r["token_times_s"][0] - r["submitted_s"] for r in results]
    gaps = np.concatenate([np.diff(r["token_times_s"]) for r in results])
    tbt = gaps[gaps > 0] / chunk
    versions = [r["weights_version"] for r in results]
    # a stream's first token lands at the fetch of the pump that admitted
    # it, and the swap happens between pumps: a first token before the
    # swap was sent means version 0; a generate() stream whose first token
    # came after the swap landed, or any request submitted after it,
    # was admitted after it (a streamed request's stamps are the
    # poller's, later than the engine's)
    before_swap = [r["weights_version"] for r in results
                   if r["token_times_s"][0] < swap["sent"]]
    after_swap = [r["weights_version"] for i, r in enumerate(results)
                  if r["submitted_s"] > swap["landed"]
                  or (i % 2 == 0 and r["token_times_s"][0] > swap["landed"])]
    adopted_equal = [a["tokens"] == r["tokens"]
                     for a, r in zip(adopted, results[:4])]
    rec = {"phase": "serving_1b_server", "card": card(),
           "requests": len(prompts), "handler_threads": 16,
           "generate_requests": len(prompts[::2]),
           "streamed_requests": len(prompts[1::2]), "slots": 8,
           "chunk_tokens": chunk, "new_tokens": new_tokens, "seconds": dt,
           "server_tokens_per_sec": len(prompts) * new_tokens / dt,
           "ttft_s": percentiles(ttft), "tbt_ms": percentiles(tbt, 1e3),
           "ttft_s_generate": percentiles(ttft[::2]),
           "ttft_s_streamed": percentiles(ttft[1::2]),
           "pumps": pumps, "poll_tick_s": POLL_TICK_S, "poll_ticks": ticks,
           "poll_rpcs": poll_rpcs, "streams_per_tick_mean": float(
               np.mean(per_tick)), "streams_per_tick_max": max(per_tick),
           "flash_launches": counts,
           "weights_versions": {v: versions.count(v) for v in set(versions)},
           "versions_before_swap": before_swap,
           "versions_after_swap": after_swap,
           "equal_to_phase_serving": sum(
               r["tokens"] == list(w) for r, w in zip(results, greedy_tokens)),
           "prefill_worker_seconds_4": prefill_s,
           "adopted_bit_equal_inline": adopted_equal,
           "stamps_ok": stamps_ok, "drained": drained,
           "pump_alive_after_shutdown": pump_alive,
           "pump_errors": errors.records}
    emit(rec)
    if errors.records:
        raise AssertionError(f"the decode pump logged errors: {errors.records}")
    if any(counts.values()):
        raise AssertionError(f"the server path launched flash kernels: {counts}")
    if not stamps_ok:
        raise AssertionError("a stream's stamps are not one a token, "
                             "in order, after its submit")
    # the poller is the server's only poll caller: one RPC a tick
    if ticks == 0 or poll_rpcs != ticks or max(per_tick) < 2:
        raise AssertionError(f"{poll_rpcs} poll RPCs for {ticks} ticks of up "
                             f"to {max(per_tick, default=0)} streams")
    if not (before_swap and after_swap and set(before_swap) == {0}
            and set(after_swap) == {1}):
        raise AssertionError(f"weight versions around the swap: before "
                             f"{before_swap}, after {after_swap}")
    if not all(adopted_equal):
        raise AssertionError(f"adopted streams differ from inline: "
                             f"{adopted_equal}")
    if not (drained and not pump_alive):
        raise AssertionError(f"shutdown: drained {drained}, pump alive "
                             f"{pump_alive}")
    params, cfg = srv.engine.params, srv.cfg
    for p, r, want in zip(prompts, results, greedy_tokens):
        assert_tokens_agree(r["tokens"], want,
                            stream_scores(params, cfg, p, r["tokens"]))
    return counts


class PoolRuntime(serve_runtime.InProcessRuntime):
    """The pool's default in-process runtime, keeping each member's
    spawn-to-healthy seconds (construction: weights to the card, cache)
    and its pump thread, to check that every pump ends."""

    def __init__(self):
        super().__init__()
        self.spawns, self.pumps = [], []

    def spawn(self, cls, kwargs, *, name="", max_concurrency=1):
        t0 = time.perf_counter()
        handle = super().spawn(cls, kwargs, name=name,
                               max_concurrency=max_concurrency)
        self.spawns.append((name, time.perf_counter() - t0))
        if hasattr(handle.obj, "_pump_thread"):
            self.pumps.append(handle.obj._pump_thread)
        return handle


def serve_through_pool(pool, requests, new_tokens, on_tokens=None,
                       concurrency=16):
    """`requests` ((prompt, lane) pairs) through the pool's entry points
    from `concurrency` handler threads: half by generate(), half by
    submit_stream() and poll_stream() every POLL_TICK_S (requests 0, 1, 4,
    5, ... and 2, 3, 6, 7, ...: the pool admits arrivals to its replicas
    in turn, so each replica gets both kinds), each streamed
    token stamped (perf_counter) as it reaches its client. `on_tokens(rid,
    n)` runs on a streaming client's thread after each poll, with the n
    tokens that client holds. Returns (results, seconds); raises a client's
    error, a truncated stream or a short one."""
    results = [None] * len(requests)
    errors = []
    sem = threading.Semaphore(concurrency)

    def one(i):
        prompt, lane = requests[i]
        try:
            with sem:
                t_sub = time.perf_counter()
                if i % 4 < 2:
                    out = pool.generate(prompt.tolist(), new_tokens, **lane)
                    results[i] = {**out, "client_submitted_s": t_sub}
                    return
                rid = pool.submit_stream({"prompt_ids": prompt.tolist(),
                                          "max_tokens": new_tokens, **lane})["rid"]
                r = {"rid": rid, "tokens": [], "logprobs": [],
                     "token_times_s": [], "client_submitted_s": t_sub,
                     "versions": set()}
                deadline = time.monotonic() + 300
                while True:
                    got = pool.poll_stream(rid)
                    t = time.perf_counter()
                    r["tokens"] += got["tokens"]
                    r["logprobs"] += got["logprobs"]
                    r["token_times_s"] += [t] * len(got["tokens"])
                    r["versions"].add(got.get("weights_version"))
                    if on_tokens is not None:
                        on_tokens(rid, len(r["tokens"]))
                    if got["done"]:
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"stream {rid} did not finish")
                    time.sleep(POLL_TICK_S)
                if got.get("truncated"):
                    raise AssertionError(f"stream {rid} was truncated")
                (r["weights_version"],) = r.pop("versions")
                results[i] = r
            if len(results[i]["tokens"]) != new_tokens:
                raise AssertionError(f"request {i} ended with "
                                     f"{len(results[i]['tokens'])} tokens")
        except Exception as e:  # noqa: BLE001 — raised on the caller
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a pool client thread did not end")
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, dt


def client_ttft(results):
    """First token's stamp minus the client's submit stamp (perf_counter:
    the replica's stamps for generate(), the client's for streams)."""
    return [r["token_times_s"][0] - r["client_submitted_s"] for r in results]


def tbt_ms(results, chunk):
    gaps = np.concatenate([np.diff(r["token_times_s"]) for r in results])
    return percentiles(gaps[gaps > 0] / chunk, 1e3)


def count_admissions(pool) -> collections.Counter:
    """Admissions (first ones and failover re-admissions) by replica name,
    counted from here on."""
    counts = collections.Counter()
    acquire = pool._acquire

    def counted(*args, **kwargs):
        rep = acquire(*args, **kwargs)
        counts[rep.name] += 1
        return rep

    pool._acquire = counted
    return counts


def phase_serving_pool(cfg, params, greedy_tokens, sampled_tokens):
    """The serving pool at Llama-1B: LLMPool (serve/llm_pool.py) over
    LLMServer replicas of phase_serving_server's shape (8 slots of 288
    rows, chunks of 32, weights from the same seed), members in this
    process (the in-process runtime). (a) 2 replicas serve phase_serving's
    greedy requests from 16 handler threads, half generate(), half
    streamed with poll_stream() every POLL_TICK_S; (b) on that pool, 8
    greedy and 8 sampled requests (phase_serving_sampled's lanes), and the
    replica of the first stream to hold 6 tokens is killed; (c) a fresh
    pool of 2 replicas and a PrefillWorker takes publish_weights of the
    same weights as a host tree and wait_version(1), then serves 8
    requests, all routed to the worker (prefill_threshold=128); (d) an
    autoscaling pool (1 to 2 replicas, 4 requests a replica) takes a burst
    of 16 requests of 32 new tokens. Raises unless (a) all of them agree with
    phase_serving's tokens (near-tie rule); (b) no client sees an error,
    every request agrees with its uninterrupted run (phase_serving's,
    phase_serving_sampled's) and the kill freed the replica's device
    memory; (c) wait_version is true, the 8 carry version 1 and equal
    (a)'s tokens bit for bit; (d) the pool reaches 2 replicas during the
    burst and drains back to 1; and, in every part, no flash launch, no
    pump error, and every pump thread ended by shutdown() or the kill.
    Returns the path's flash launches (none)."""
    warm, prompts = serving_requests()
    new_tokens, chunk = 128, 32
    server_kw = dict(slots=8, max_len=288, chunk_tokens=chunk,
                     prompt_buckets=(128,), seed=SEED, device="cuda")
    greedy_reqs = [(p, {}) for p in prompts]
    errors = PumpErrors()
    port_log = logging.getLogger("ray_tpu_torch")
    port_log.addHandler(errors)
    rt = PoolRuntime()
    rec = {"phase": "serving_1b_pool", "card": card()}
    try:
        fa.reset_launch_count()
        # (a) traffic over 2 replicas
        pool = llm_pool.LLMPool("1b", min_replicas=2, max_replicas=2,
                                autoscale=False, runtime=rt, **server_kw)
        threads = [threading.Thread(target=pool.generate,
                                    args=(warm.tolist(), 32))
                   for _ in range(2)]  # one first prefill + chunk a replica
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        admitted = count_admissions(pool)
        t_mono = time.monotonic()
        results, dt = serve_through_pool(pool, greedy_reqs, new_tokens)
        pool_ttft = [t for stamp, t, _ in pool._ttfts if stamp >= t_mono]
        ttft = client_ttft(results)
        rec["a_traffic"] = {
            "replicas": 2, "requests": len(prompts), "handler_threads": 16,
            "seconds": dt,
            "pool_tokens_per_sec": len(prompts) * new_tokens / dt,
            "engine_tokens_per_sec": RECORDS["serving_1b"][
                "engine_tokens_per_sec"],
            "server_tokens_per_sec": RECORDS.get("serving_1b_server", {}).get(
                "server_tokens_per_sec"),
            # the pool's own records (queue wait + replica stamps) of the
            # generate() calls still in its 30 s window
            "ttft_s_generate_record_ttft": percentiles(pool_ttft),
            "ttft_records": len(pool_ttft),
            "ttft_s_streamed_client": percentiles(
                [t for i, t in enumerate(ttft) if i % 4 >= 2]),
            "ttft_s_all_client": percentiles(ttft),
            "tbt_ms": tbt_ms(results, chunk),
            "admissions_per_replica": dict(admitted),
            "equal_to_phase_serving": sum(
                r["tokens"] == list(w) for r, w in zip(results, greedy_tokens)),
            "stats": pool.stats()}
        for p, r, want in zip(prompts, results, greedy_tokens):
            assert_tokens_agree(r["tokens"], want,
                                stream_scores(params, cfg, p, r["tokens"]))
        inline = [r["tokens"] for r in results]

        # (b) failover: kill the replica of the first stream at 6 tokens
        lanes = [{}] * 8 + [dict(SAMPLED, seed=1000 + i) for i in range(8)]
        fail_prompts = prompts[:8] * 2
        wants = list(greedy_tokens[:8]) + list(sampled_tokens[:8])
        kill = {}
        kill_lock = threading.Lock()
        admitted = count_admissions(pool)
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()

        def on_tokens(rid, n):
            with kill_lock:
                victim = (pool._streams.get(rid) or {}).get("rep")
                if n < 6 or kill or victim is None:
                    return
                with pool._lock:
                    kill["streams"] = [orid for orid, orec in
                                       pool._streams.items()
                                       if orec.get("rep") is victim]
                kill.update(replica=victim.name, inflight=victim.inflight,
                            t=time.perf_counter(),
                            pump=victim.handle.obj._pump_thread)
                rt.kill(victim.handle)

        results_b, dt_b = serve_through_pool(
            pool, list(zip(fail_prompts, lanes)), new_tokens, on_tokens)
        kill["pump"].join(timeout=60)
        torch.cuda.synchronize()
        freed = mem_before - torch.cuda.memory_allocated()
        replica_bytes = (sum(t.numel() * t.element_size()
                             for t in tree_leaves(params))
                         + 2 * cfg.n_layers * 8 * 288 * cfg.n_kv_heads
                         * cfg.head_dim * 2)
        moved = [r for r in results_b
                 if r.get("rid") in kill["streams"]
                 or ("rid" not in r and r["submitted_s"] > kill["t"])]
        rec["b_failover"] = {
            "requests": len(results_b), "greedy": 8, "sampled": 8,
            "seconds": dt_b, "killed": kill["replica"],
            "victim_inflight": kill["inflight"],
            "admissions_per_replica": dict(admitted),
            "streams_reassigned": len(kill["streams"]),
            "generates_resubmitted": sum("rid" not in r for r in moved),
            "kill_to_first_fresh_token_s": sorted(
                min(t for t in r["token_times_s"] if t > kill["t"]) - kill["t"]
                for r in moved),
            "replicas_left": len(pool._alive()),
            "victim_pump_ended": not kill["pump"].is_alive(),
            "device_bytes_freed_by_kill": freed,
            "replica_device_bytes": replica_bytes,
            "agreement": agreement(params, cfg, fail_prompts,
                                   [r["tokens"] for r in results_b], wants,
                                   lanes)}
        for p, r, want, lane in zip(fail_prompts, results_b, wants, lanes):
            assert_tokens_agree(r["tokens"], want, stream_scores(
                params, cfg, p, r["tokens"], **lane))
        if not (moved and kill["streams"] and len(pool._alive()) == 1
                and not kill["pump"].is_alive()):
            raise AssertionError(f"failover: {rec['b_failover']}")
        if freed < 0.95 * replica_bytes:
            raise AssertionError(f"the kill freed {freed} bytes of the "
                                 f"replica's {replica_bytes}")
        pool.shutdown()
        del pool

        # (c) publish to 2 replicas + 1 prefill worker, then disaggregate
        pool = llm_pool.LLMPool("1b", min_replicas=2, max_replicas=2,
                                autoscale=False, prefill_workers=1,
                                prefill_threshold=128, runtime=rt, **server_kw)
        host = tree_unflatten(params, [x.cpu() for x in tree_leaves(params)])
        t0 = time.perf_counter()
        version = pool.publish_weights(host)
        publish_s = time.perf_counter() - t0
        adopted = pool.wait_version(version, timeout=120)
        adoption_s = time.perf_counter() - t0
        del host
        routed0 = pool._prefill_rr
        results_c, dt_c = serve_through_pool(pool, greedy_reqs[:8], new_tokens)
        routed = pool._prefill_rr - routed0
        rec["c_publish"] = {
            "version": version, "wait_version": adopted,
            "publish_s": publish_s, "publish_to_adoption_s": adoption_s,
            "requests": 8, "routed_to_prefill_worker": routed,
            "seconds": dt_c,
            "versions": [r["weights_version"] for r in results_c],
            "bit_equal_to_inline": [r["tokens"] == t
                                    for r, t in zip(results_c, inline)]}
        pool.shutdown()
        del pool
        if not (adopted and version == 1 and routed == 8
                and rec["c_publish"]["versions"] == [1] * 8
                and all(rec["c_publish"]["bit_equal_to_inline"])):
            raise AssertionError(f"publish: {rec['c_publish']}")

        # (d) autoscale from 1 to 2 replicas under a burst, and back
        pool = llm_pool.LLMPool("1b", min_replicas=1, max_replicas=2,
                                target_queue_per_replica=4,
                                max_inflight_per_replica=8, autoscale=True,
                                runtime=rt, **server_kw)
        pool.AUTOSCALE_PERIOD_S = 0.1
        time.sleep(1.0)  # the loop's first sleep is the class period
        n_spawned = len(rt.spawns)
        admitted = count_admissions(pool)
        seen = []  # (seconds from the burst's start, replicas in rotation)

        def watch():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                n = len(pool._replicas)
                seen.append((time.perf_counter() - t0, n))
                if n == 1 and any(m == 2 for _, m in seen):
                    return
                time.sleep(0.01)

        watcher = threading.Thread(target=watch)
        t0 = time.perf_counter()
        watcher.start()
        results_d, dt_d = serve_through_pool(pool, greedy_reqs[:16], 32)
        watcher.join(timeout=150)
        two = [t for t, n in seen if n == 2]
        rec["d_autoscale"] = {
            "requests": 16, "new_tokens": 32, "burst_s": dt_d,
            "max_replicas": max(n for _, n in seen),
            "two_replicas_at_s": two[0] if two else None,
            "spawn_to_healthy_s": [s for _, s in rt.spawns[n_spawned:]],
            "admissions_per_replica": dict(admitted),
            "back_to_one_at_s": seen[-1][0] if two else None,
            "replicas_after": len(pool._replicas)}
        for p, r, want in zip(prompts, results_d, greedy_tokens):
            assert_tokens_agree(r["tokens"], want[:32], stream_scores(
                params, cfg, p, r["tokens"]))
        pool.shutdown()
        del pool
        if not (two and two[0] < dt_d and len(rt.spawns) - n_spawned == 1
                and rec["d_autoscale"]["replicas_after"] == 1):
            raise AssertionError(f"autoscale: {rec['d_autoscale']}")
        counts = fa.launch_counts()
    finally:
        port_log.removeHandler(errors)
    for th in rt.pumps:
        th.join(timeout=30)
    rec.update(flash_launches=counts, pump_threads=len(rt.pumps),
               pumps_alive=sum(th.is_alive() for th in rt.pumps),
               pump_errors=errors.records)
    emit(rec)
    if errors.records:
        raise AssertionError(f"the decode pump logged errors: {errors.records}")
    if any(counts.values()):
        raise AssertionError(f"the pool path launched flash kernels: {counts}")
    if rec["pumps_alive"]:
        raise AssertionError(f"{rec['pumps_alive']} pump threads outlived "
                             f"their pools")
    return counts


class TimedProcessRuntime(process_runtime.ProcessRuntime):
    """The process runtime, keeping each put's bytes (in the store's
    files) and seconds."""

    def __init__(self):
        super().__init__()
        self.puts = []

    def put(self, tree, *, owned=False):
        t0 = time.perf_counter()
        ref = super().put(tree, owned=owned)
        nbytes = sum(os.path.getsize(os.path.join(ref.path, f))
                     for f in os.listdir(ref.path))
        self.puts.append((nbytes, time.perf_counter() - t0))
        return ref


def spawn_split(rt) -> list:
    """Each member's spawn, seconds: boot (a new interpreter up to the
    member's code, imports included), build (its constructor: the CUDA
    context, weights mapped from the store and moved to the card, cache)
    and their sum."""
    return [{"name": m.name, "boot_s": m.boot_s, "build_s": m.build_s,
             "spawn_s": m.boot_s + m.build_s} for m in rt._members]


def processes_gone(members) -> bool:
    """Every member's process has exited and been reaped."""
    for m in members:
        if m.process.exitcode is None:
            return False
        try:
            os.kill(m.pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


def free_device_bytes() -> int:
    """Free bytes on the card, counted over every process on it (this
    one's cached blocks released first)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def phase_serving_pool_procs(cfg, params, greedy_tokens, sampled_tokens):
    """phase_serving_pool's pool with its members in processes of their
    own: LLMPool("1b") of 2 LLMServer replicas of the same shape (8 slots
    of 288 rows, chunks of 32, prompt bucket 128, seed SEED), each a
    spawned process with a CUDA context of its own
    (serve.process_runtime.ProcessRuntime), the weights put once into
    the runtime's file store and mapped by each replica. (a) phase_serving's
    16 greedy requests of 128 new tokens from 16 handler threads, half
    generate(), half streamed; (c) publish_weights of the same weights as
    a host tree, wait_version(1) in every replica process, then 4 of (a)'s
    requests; (b) 4 greedy and 4 sampled requests (phase_serving_sampled's
    lanes), the replica of the first stream to hold 6 tokens killed
    (SIGKILL). (c) runs before (b), so that the publish reaches two
    processes. Raises unless (a) every stream agrees with phase_serving's
    tokens (near-tie rule); (c) wait_version is true, both processes
    report version 1 and the 4 equal (a)'s tokens bit for bit; (b) no
    client sees an error, every request agrees with its uninterrupted run,
    and the card's free memory (torch.cuda.mem_get_info, before the spawn,
    with both replicas alive, right before and after the kill) shows the
    killed process's memory back: at least 0.95 of its weights and cache,
    and 0.9 of a replica's footprint at spawn; the replicas' pids are not
    this process's, every process has exited after the kill and the
    pool's shutdown, and no flash kernel is launched. Prints the spawn
    seconds per member, the put's bytes and seconds, the publish's
    adoption seconds, tokens/s, client TTFT and TBT and kill-to-first-
    fresh-token beside serving_1b_pool's figures of this run."""
    warm, prompts = serving_requests()
    new_tokens, chunk = 128, 32
    server_kw = dict(slots=8, max_len=288, chunk_tokens=chunk,
                     prompt_buckets=(128,), seed=SEED, device="cuda")
    greedy_reqs = [(p, {}) for p in prompts]
    inproc = RECORDS.get("serving_1b_pool", {})
    rt = TimedProcessRuntime()
    rec = {"phase": "serving_1b_pool_procs", "card": card(),
           "runtime": "ProcessRuntime", "parent_pid": os.getpid()}
    pool = None
    try:
        fa.reset_launch_count()
        free_before = free_device_bytes()
        t0 = time.perf_counter()
        pool = llm_pool.LLMPool("1b", min_replicas=2, max_replicas=2,
                                autoscale=False, runtime=rt, **server_kw)
        build_s = time.perf_counter() - t0
        members = [r.handle for r in pool._alive()]
        free_alive = free_device_bytes()
        threads = [threading.Thread(target=pool.generate,
                                    args=(warm.tolist(), 32))
                   for _ in range(2)]  # one first prefill + chunk a replica
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        footprint = (free_before - free_alive) / 2
        rec["processes"] = {
            "pids": [m.pid for m in members],
            "pool_build_s": build_s,
            "spawn_split": spawn_split(rt),
            "in_process_spawn_s": inproc.get("d_autoscale", {}).get(
                "spawn_to_healthy_s"),
            "put_bytes": [b for b, _ in rt.puts],
            "put_s": [s for _, s in rt.puts],
            "free_gb_before_spawn": free_before / 2**30,
            "free_gb_replicas_alive": free_alive / 2**30,
            "replica_footprint_gb": footprint / 2**30}
        if not (len({m.pid for m in members}) == 2
                and os.getpid() not in {m.pid for m in members}):
            raise AssertionError(f"replica processes: {rec['processes']}")

        # (a) traffic over 2 replica processes
        admitted = count_admissions(pool)
        results, dt = serve_through_pool(pool, greedy_reqs, new_tokens)
        ttft = client_ttft(results)
        rec["a_traffic"] = {
            "replicas": 2, "requests": len(prompts), "handler_threads": 16,
            "seconds": dt,
            "pool_tokens_per_sec": len(prompts) * new_tokens / dt,
            "ttft_s_streamed_client": percentiles(
                [t for i, t in enumerate(ttft) if i % 4 >= 2]),
            "ttft_s_all_client": percentiles(ttft),
            "tbt_ms": tbt_ms(results, chunk),
            "admissions_per_replica": dict(admitted),
            "equal_to_phase_serving": sum(
                r["tokens"] == list(w) for r, w in zip(results, greedy_tokens)),
            "in_process": {k: inproc.get("a_traffic", {}).get(k) for k in (
                "pool_tokens_per_sec", "ttft_s_streamed_client",
                "ttft_s_all_client", "tbt_ms")}}
        for p, r, want in zip(prompts, results, greedy_tokens):
            assert_tokens_agree(r["tokens"], want,
                                stream_scores(params, cfg, p, r["tokens"]))
        inline = [r["tokens"] for r in results]

        # (c) publish the same weights to both processes
        host = tree_unflatten(params, [x.cpu() for x in tree_leaves(params)])
        n_puts = len(rt.puts)
        t0 = time.perf_counter()
        version = pool.publish_weights(host)
        publish_s = time.perf_counter() - t0
        adopted = pool.wait_version(version, timeout=120)
        adoption_s = time.perf_counter() - t0
        del host
        versions = [rt.get(rt.call(m, "weights_version"), timeout=60)
                    for m in members]
        results_c, dt_c = serve_through_pool(pool, greedy_reqs[:4], new_tokens)
        rec["c_publish"] = {
            "version": version, "wait_version": adopted,
            "replica_versions": versions,
            "put_bytes": [b for b, _ in rt.puts[n_puts:]],
            "put_s": [s for _, s in rt.puts[n_puts:]],
            "publish_s": publish_s, "publish_to_adoption_s": adoption_s,
            "adopt_s": adoption_s - publish_s,
            "requests": 4, "seconds": dt_c,
            "versions": [r["weights_version"] for r in results_c],
            "bit_equal_to_a": [r["tokens"] == t
                               for r, t in zip(results_c, inline)],
            "in_process": {k: inproc.get("c_publish", {}).get(k) for k in (
                "publish_s", "publish_to_adoption_s")}}
        if not (adopted and version == 1 and versions == [1, 1]
                and rec["c_publish"]["versions"] == [1] * 4
                and all(rec["c_publish"]["bit_equal_to_a"])):
            raise AssertionError(f"publish: {rec['c_publish']}")

        # (b) failover: SIGKILL the replica of the first stream at 6 tokens
        lanes = [{}] * 4 + [dict(SAMPLED, seed=1000 + i) for i in range(4)]
        fail_prompts = prompts[:4] * 2
        wants = list(greedy_tokens[:4]) + list(sampled_tokens[:4])
        kill = {}
        kill_lock = threading.Lock()
        admitted = count_admissions(pool)
        replica_bytes = (sum(t.numel() * t.element_size()
                             for t in tree_leaves(params))
                         + 2 * cfg.n_layers * 8 * 288 * cfg.n_kv_heads
                         * cfg.head_dim * 2)

        def on_tokens(rid, n):
            with kill_lock:
                victim = (pool._streams.get(rid) or {}).get("rep")
                if n < 6 or kill or victim is None:
                    return
                with pool._lock:
                    kill["streams"] = [orid for orid, orec in
                                       pool._streams.items()
                                       if orec.get("rep") is victim]
                free_pre = free_device_bytes()
                kill.update(replica=victim.name, handle=victim.handle,
                            inflight=victim.inflight, t=time.perf_counter())
                rt.kill(victim.handle)
                kill["kill_s"] = time.perf_counter() - kill["t"]
                deadline = time.monotonic() + 10  # the process's teardown
                while True:
                    kill["freed"] = free_device_bytes() - free_pre
                    if (kill["freed"] >= 0.95 * replica_bytes
                            or time.monotonic() > deadline):
                        break
                    time.sleep(0.05)

        results_b, dt_b = serve_through_pool(
            pool, list(zip(fail_prompts, lanes)), new_tokens, on_tokens)
        moved = [r for r in results_b
                 if r.get("rid") in kill["streams"]
                 or ("rid" not in r and r["submitted_s"] > kill["t"])]
        fresh = sorted(min(t for t in r["token_times_s"] if t > kill["t"])
                       - kill["t"] for r in moved)
        rec["b_failover"] = {
            "requests": len(results_b), "greedy": 4, "sampled": 4,
            "seconds": dt_b, "killed": kill["replica"],
            "killed_pid": kill["handle"].pid,
            "kill_and_reap_s": kill["kill_s"],
            "victim_inflight": kill["inflight"],
            "admissions_per_replica": dict(admitted),
            "streams_reassigned": len(kill["streams"]),
            "generates_resubmitted": sum("rid" not in r for r in moved),
            "kill_to_first_fresh_token_s": fresh,
            "replicas_left": len(pool._alive()),
            "victim_exited": processes_gone([kill["handle"]]),
            "device_bytes_freed_by_kill": kill["freed"],
            "replica_device_bytes": replica_bytes,
            "agreement": agreement(params, cfg, fail_prompts,
                                   [r["tokens"] for r in results_b], wants,
                                   lanes),
            "in_process": {"kill_to_first_fresh_token_s": inproc.get(
                "b_failover", {}).get("kill_to_first_fresh_token_s")}}
        for p, r, want, lane in zip(fail_prompts, results_b, wants, lanes):
            assert_tokens_agree(r["tokens"], want, stream_scores(
                params, cfg, p, r["tokens"], **lane))
        if not (moved and kill["streams"] and len(pool._alive()) == 1
                and rec["b_failover"]["victim_exited"]):
            raise AssertionError(f"failover: {rec['b_failover']}")
        if not (kill["freed"] >= 0.95 * replica_bytes
                and kill["freed"] >= 0.9 * footprint):
            raise AssertionError(
                f"the kill freed {kill['freed']} bytes of the replica's "
                f"{replica_bytes} (footprint {footprint})")
        pool.shutdown()
        rec["all_exited_after_shutdown"] = processes_gone(members)
        pool = None
        counts = fa.launch_counts()
    finally:
        if pool is not None:
            pool.shutdown()
        rt.shutdown()
    rec["flash_launches"] = counts
    emit(rec)
    if not rec["all_exited_after_shutdown"]:
        raise AssertionError("replica processes outlived their pool")
    if any(counts.values()):
        raise AssertionError(f"the pool path launched flash kernels: {counts}")
    return counts


def exactness_f32_engine_paths(cfg, params, prompts, greedy, new_tokens,
                               tag="exactness_f32_2layer"):
    """phase_exactness_f32's model (1B width, 2 layers, f32, TF32 off)
    through the other engine paths, each under the near-tie rule
    (NEAR_TIE_TOL) against the path it must reproduce: sampled streams
    amid others vs alone; speculation at depth 2 and 4 vs plain, greedy
    and sampled; a slot speculating within 4 rows of the cache end; warm
    (prefix cache) vs cold admission; disaggregated vs inline admission;
    and behaviour logprobs vs the teacher-forced forward (the f32 flash
    kernel) within 1e-4."""
    kw = dict(slots=8, max_len=288, chunk_tokens=32, prompt_buckets=(64, 128),
              device="cuda")
    lanes = [dict(SAMPLED, seed=3000 + i) for i in range(len(prompts))]
    greedy_lanes = [{}] * len(prompts)

    def run(eng, ps, ls, n=new_tokens, kvs=None):
        return [s.tokens for s in serve(eng, ps, n, ls, kvs)[0]], eng

    def check(name, ps, got, want, ls, **extra):
        divs = []
        for p, a, b, lane in zip(ps, got, want, ls):
            i, margin = assert_tokens_agree(
                a, b, stream_scores(params, cfg, p, a, **lane))
            if i is not None:
                divs.append({"at": i, "margin": margin})
        emit({"phase": tag, "check": name, "card": card(),
              "streams": len(ps), "divergences": divs,
              "near_tie_tol": NEAR_TIE_TOL, **extra, "ok": True})

    eng = decode_engine.RaggedDecoder(params, cfg, **kw)
    sampled, _ = run(eng, prompts, lanes)
    alone = [run(eng, [prompts[j]], [lanes[j]])[0][0] for j in (0, 5, 11)]
    check("sampled_amid_others_vs_alone", [prompts[j] for j in (0, 5, 11)],
          alone, [sampled[j] for j in (0, 5, 11)], [lanes[j] for j in (0, 5, 11)])
    for depth in (2, 4):
        spec_kw = dict(kw, spec_depth=depth)
        got, eng = run(decode_engine.RaggedDecoder(params, cfg, **spec_kw),
                       prompts, greedy_lanes)
        check(f"spec_depth{depth}_greedy_vs_plain", prompts, got, greedy,
              greedy_lanes, acceptance_rate=eng.stats()["spec"]["acceptance_rate"])
        got, eng = run(decode_engine.RaggedDecoder(params, cfg, **spec_kw),
                       prompts, lanes)
        check(f"spec_depth{depth}_sampled_vs_plain", prompts, got, sampled,
              lanes, acceptance_rate=eng.stats()["spec"]["acceptance_rate"])
    # 150-token prompts in 160 rows: the depth-4 rounds run past the end
    rng = np.random.RandomState(SEED + 2)
    end_prompts = [rng.randint(1, 30000, 150).astype(np.int32) for _ in range(4)]
    end_kw = dict(kw, max_len=160, prompt_buckets=(160,))
    for name, ls in (("greedy", greedy_lanes[:4]), ("sampled", lanes[:4])):
        plain_toks, _ = run(decode_engine.RaggedDecoder(params, cfg, **end_kw),
                            end_prompts, ls, n=9)
        got, _ = run(decode_engine.RaggedDecoder(params, cfg, spec_depth=4,
                                                 **end_kw), end_prompts, ls, n=9)
        check(f"spec_near_cache_end_{name}", end_prompts, got, plain_toks, ls)
    # a shared 64-token head: cold engine vs prefix-cached engine
    head = rng.randint(1, 30000, 64).astype(np.int32)
    pc_prompts = [np.concatenate([head, rng.randint(1, 30000, int(n)).astype(np.int32)])
                  for n in rng.randint(8, 60, 12)]
    cold, _ = run(decode_engine.RaggedDecoder(params, cfg, **kw), pc_prompts, lanes)
    pc = kv_prefix_cache.PrefixCache(block=32)
    warm, _ = run(decode_engine.RaggedDecoder(params, cfg, prefix_cache=pc, **kw),
                  pc_prompts, lanes)
    check("warm_vs_cold", pc_prompts, warm, cold, lanes, **pc.stats())
    if pc.stats()["hits"] == 0:
        raise AssertionError("the prefix cache served no hit")
    # disaggregated: prefill_kv_sampled, the host hop, submit_prefilled
    padded = np.zeros((len(prompts), 128), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    k, v, tok0, lp0 = decode_engine.prefill_kv_sampled(
        params, torch.from_numpy(padded).cuda(), [len(p) for p in prompts],
        [x["seed"] for x in lanes], [x["temperature"] for x in lanes],
        [x["top_p"] for x in lanes], cfg, 288)
    k, v = k.cpu(), v.cpu()
    kvs = [{"k": k[:, i], "v": v[:, i], "first_token": int(tok0[i]),
            "first_logprob": float(lp0[i]), "true_len": len(p)}
           for i, p in enumerate(prompts)]
    got, _ = run(decode_engine.RaggedDecoder(params, cfg, **kw), prompts, lanes,
                 kvs=kvs)
    check("disaggregated_vs_inline", prompts, got, sampled, lanes)
    # behaviour logprobs against the teacher-forced forward
    tf_lanes = [dict(temperature=1.0, top_p=1.0, seed=4000 + i) for i in range(8)]
    streams = serve(decode_engine.RaggedDecoder(params, cfg, **kw), prompts[:8],
                    new_tokens, tf_lanes)[0]
    gaps = []
    fa.reset_launch_count()
    for p, s in zip(prompts[:8], streams):
        seq = torch.from_numpy(np.concatenate([p, np.asarray(s.tokens, np.int32)]))
        logits = llama.forward(params, seq[None].cuda(), cfg)[0].float()
        lsm = torch.log_softmax(logits[len(p) - 1:-1], dim=-1)
        ref = lsm.gather(-1, seq[len(p):, None].long().cuda())[:, 0].cpu().numpy()
        gaps.append(float(np.abs(np.asarray(s.logprobs, np.float32) - ref).max()))
    counts = fa.launch_counts()
    ok = max(gaps) <= 1e-4 and counts["flash_fwd"] == 8 * cfg.n_layers
    emit({"phase": tag, "card": card(),
          "check": "logprobs_vs_teacher_forced",
          "streams": 8, "max_gap": max(gaps), "tol": 1e-4, "launches": counts,
          "ok": ok})
    if not ok:
        raise AssertionError(f"f32 logprobs vs teacher-forced: {gaps}, "
                             f"launches {counts}")


# -- the mixture-of-experts Llama: the 1B widths with 8 experts, top-2 --

MOE_1B_PARAMS = 6_499_002_368  # JAX's num_params() of moe_1b_config()


def moe_1b_config(**over):
    """bench_1b_config with Mixtral 8x7B's routing (8 experts, top-2;
    Jiang et al. 2024, arXiv:2401.04088) and the JAX package's capacity
    defaults (capacity routing, factor 1.25)."""
    return llama.LlamaConfig(**{**bench_1b_config().__dict__, "n_experts": 8,
                                "top_k": 2, "moe_impl": "capacity",
                                "capacity_factor": 1.25, **over})


def moe_forward_flops(cfg, b, t):
    """Multiply-add flops (2 a product) of the products one forward of
    B x T tokens runs: the projections, the causal attention pairs, the
    router, the capacity dispatch and combine (T x E*C per row each) and
    the experts over their E*C buffer rows a row, the unembedding. Counts
    what the MoE layer computes, not 6 x num_params (which counts every
    expert for every token)."""
    d, f, e, hd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.head_dim
    hq, hkv, n = cfg.n_heads, cfg.n_kv_heads, b * t
    c = llama.moe_capacity(cfg, t)
    attn = 2 * n * d * (2 * hq * hd + 2 * hkv * hd) \
        + 2 * 2 * hd * b * hq * t * (t + 1) // 2
    moe = 2 * n * d * e + 2 * 2 * b * t * e * c * d + 3 * 2 * b * e * c * d * f
    return cfg.n_layers * (attn + moe) + 2 * n * d * cfg.vocab_size


def capacity_slots_recorded(fn):
    """Runs fn() with every llama._capacity_slots call recorded: returns
    (fn's result, [per call: (choices dropped, choices routed)])."""
    seen = []
    plain = llama._capacity_slots

    def recording(cfg, gates, capacity):
        out = plain(cfg, gates, capacity)
        seen.append(out[2] >= capacity)
        return out

    llama._capacity_slots = recording
    try:
        result = fn()
    finally:
        llama._capacity_slots = plain
    return result, [(int(x.sum()), x.numel()) for x in seen]


def phase_init_1b_moe():
    """The 1B-MoE model on the card: seeded init_params (drawn in f32 a
    leaf at a time, then cast to bf16)."""
    cfg = moe_1b_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 800)
    params = llama.init_params(cfg, g, device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = cfg.num_params()
    ok = n == MOE_1B_PARAMS and sum(x.numel() for x in leaves) == n
    emit({"phase": "init_1b_moe", "card": card(), "n_params": n,
          "expected_n_params": MOE_1B_PARAMS, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff,
          "n_experts": cfg.n_experts, "top_k": cfg.top_k,
          "moe_impl": cfg.moe_impl, "capacity_factor": cfg.capacity_factor,
          "param_bytes": sum(x.numel() * x.element_size() for x in leaves),
          "allocated_bytes": torch.cuda.memory_allocated() - before,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated() - before,
          "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"1B-MoE: {n} params, expected {MOE_1B_PARAMS}")
    return cfg, params


def phase_scoring_1b_moe(cfg, params, peaks):
    """llama.forward of the 1B-MoE at B2 x T2048 (capacity 640 a row):
    flash_fwd_sm90 once a layer, finite logits, a second forward equal
    bit for bit; ms, tokens/s, the products' rate, and the expert choices
    dropped in each layer (summed over the batch)."""
    b, t = 2, 2048
    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    toks = torch.randint(1, 30000, (b, t), generator=g, device="cuda")
    fa.reset_launch_count()
    logits, drops = capacity_slots_recorded(
        lambda: llama.forward(params, toks, cfg))
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    launched_only("flash_fwd_sm90", counts)
    again = llama.forward(params, toks, cfg)
    replay_equal = bool(torch.equal(logits, again))
    finite = bool(torch.isfinite(logits.float()).all())
    ms = time_ms(lambda: llama.forward(params, toks, cfg), iters=5, warmup=1)
    flops = moe_forward_flops(cfg, b, t)
    capacity = llama.moe_capacity(cfg, t)
    ok = (counts["flash_fwd_sm90"] == cfg.n_layers and finite and replay_equal
          and len(drops) == cfg.n_layers
          and all(n == b * t * cfg.top_k for _, n in drops))
    emit({"phase": "scoring_1b_moe", "card": card(), "batch": b, "seq": t,
          "capacity": capacity, "flash_launches": counts["flash_fwd_sm90"],
          "logits_shape": list(logits.shape), "finite": finite,
          "replay_bit_equal": replay_equal, "forward_ms": ms,
          "tokens_per_sec": b * t / (ms / 1e3),
          "dense_1b_forward_ms": RECORDS["scoring_forward_1b"]["forward_ms"],
          "product_flops": flops,
          "product_tflops_per_sec": flops / (ms / 1e3) / 1e12,
          "product_share_of_peak": flops / (ms / 1e3) / peaks[0],
          "dropped_choices_per_layer": [d for d, _ in drops],
          "choices_per_layer": b * t * cfg.top_k, "ok": ok})
    if not ok:
        raise AssertionError(f"1B-MoE scoring: launches {counts}, finite "
                             f"{finite}, replay {replay_equal}, drops {drops}")
    del logits, again
    return counts


def phase_serving_1b_moe(cfg, params):
    """phase_serving's requests on the 1B-MoE (8 slots of 288 rows,
    chunks of 32): greedy, the served sequences scored again (22
    flash_fwd_sm90), then sampled (temperature 0.8, top_p 0.95, seed 1000
    + i) twice, the two runs equal bit for bit (tokens and logprobs).
    Tokens/s, pump times and launches per decode step beside the dense
    1B's of this run. The first SHORT_REQUESTS requests."""
    warm, prompts = serving_requests(SHORT_REQUESTS)
    eng = serving_engine(cfg, params)
    serve(eng, [warm], 32, [{}])  # untimed
    fa.reset_launch_count()
    pumps = []
    streams, dt = serve(eng, prompts, 128, [{}] * len(prompts), pumps=pumps)
    engine_counts = fa.launch_counts()
    seqs = torch.from_numpy(np.stack([
        np.concatenate([p, np.asarray(s.tokens, np.int32)])
        for p, s in zip(prompts, streams)])).cuda()
    logits = llama.forward(params, seqs, cfg)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    score_launches = counts["flash_fwd_sm90"] - engine_counts["flash_fwd_sm90"]
    finite = bool(torch.isfinite(logits.float()).all())
    # capacity routing: the teacher-forced rows route the whole sequence,
    # the engine its bucket and then one token a step, so they may differ
    match = (logits[:, 127:-1].argmax(-1) == seqs[:, 128:]).float().mean().item()
    launches = decode_step_launches(cfg, params)
    dense = RECORDS["serving_1b"]
    rec = {"phase": "serving_1b_moe", "card": card(), "requests": len(prompts),
           "slots": 8, "prompt_len": 128, "new_tokens": 128, "chunk_tokens": 32,
           "seconds": dt, "engine_tokens_per_sec": len(prompts) * 128 / dt,
           "dense_engine_tokens_per_sec": dense["engine_tokens_per_sec"],
           **pump_times(pumps), "engine_flash_launches": engine_counts,
           "scoring_flash_launches": score_launches, "scoring_finite": finite,
           "served_equals_teacher_forced_argmax": match,
           "launches_per_decode_step": launches,
           "dense_launches_per_decode_step":
               RECORDS["serving_1b_sampled"]["launches_per_decode_step"],
           "stats": eng.stats()}
    emit(rec)
    if any(engine_counts.values()) or score_launches != cfg.n_layers \
            or not finite:
        raise AssertionError(f"1B-MoE serving: engine launches "
                             f"{engine_counts}, scoring {score_launches}, "
                             f"finite {finite}")
    lanes = [dict(SAMPLED, seed=1000 + i) for i in range(len(prompts))]
    runs = []
    for _ in range(2):
        pumps = []
        fa.reset_launch_count()
        got, dt = serve(eng, prompts, 128, lanes, pumps=pumps)
        add_counts(counts, fa.launch_counts())
        runs.append((got, dt, pumps))
    (a, dt, pumps), (b, dt2, _) = runs
    equal = sum(x.tokens == y.tokens and bits_equal(x.logprobs, y.logprobs)
                for x, y in zip(a, b))
    lps = np.array([s.logprobs for s in a], np.float32)
    ok = bool(equal == len(prompts) and np.isfinite(lps).all()
              and (lps <= 0).all())
    emit({"phase": "serving_1b_moe_sampled", "card": card(),
          "requests": len(prompts), "new_tokens": 128, **SAMPLED,
          "seeds": "1000 + i", "seconds": dt,
          "engine_tokens_per_sec": len(prompts) * 128 / dt,
          "second_run_tokens_per_sec": len(prompts) * 128 / dt2,
          "dense_engine_tokens_per_sec":
              RECORDS["serving_1b_sampled"]["engine_tokens_per_sec"],
          **pump_times(pumps), "second_run_bit_equal_streams": equal,
          "logprob_min": float(lps.min()), "ok": ok})
    if not ok:
        raise AssertionError(f"1B-MoE sampled: {equal} of {len(prompts)} "
                             f"streams replayed bit for bit")
    return counts


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def phase_moe_layer_card_vs_cpu(cfg):
    """One capacity-routed MoE MLP at the 1B-MoE widths in f32 (TF32 off),
    x [1, 1024, 2048] from a seeded numpy stream, capacity factor 1.25
    (capacity 320; expert 0's router column scaled 4x, so that tokens
    drop), on the card and on the CPU from the same
    weights: the same slots and drops, outputs within a relative L2 of
    1e-4. Then, on the card, the dense impl against the capacity impl at
    capacity factor = n_experts (nothing can drop), same tolerance."""
    cfg = llama.LlamaConfig(**{**cfg.__dict__, "dtype": "float32"})
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator().manual_seed(SEED + 900)
    cpu = {"router": torch.randn(d, e, generator=g) / d ** 0.5,
           "w_gate": torch.randn(e, d, f, generator=g) / d ** 0.5,
           "w_up": torch.randn(e, d, f, generator=g) / d ** 0.5,
           "w_down": torch.randn(e, f, d, generator=g) / f ** 0.5}
    # a random router spreads tokens evenly (no expert near 1.25 x its
    # share); one favoured expert, as trained routers have, makes drops
    cpu["router"][:, 0] *= 4.0
    card_p = {k: v.cuda() for k, v in cpu.items()}
    x = torch.from_numpy(np.random.RandomState(SEED + 900).randn(
        1, 1024, d).astype(np.float32))
    xc = x.cuda()
    capacity = llama.moe_capacity(cfg, x.shape[1])
    slots = {}
    for dev, p, xx in (("cpu", cpu, x), ("cuda", card_p, xc)):
        gates = llama.moe_gates(cfg, p["router"], xx)
        _, topi, pos = llama._capacity_slots(cfg, gates, capacity)
        slots[dev] = (topi.cpu(), pos.cpu())
    t0 = time.perf_counter()
    y_cpu = llama._moe_mlp_capacity(cfg, cpu, x)
    cpu_s = time.perf_counter() - t0
    y_card = llama._moe_mlp_capacity(cfg, card_p, xc)
    torch.cuda.synchronize()
    same_slots = all(torch.equal(a, b) for a, b in zip(slots["cpu"],
                                                       slots["cuda"]))
    drops = {dev: int((pos >= capacity).sum()) for dev, (_, pos) in slots.items()}
    rel = rel_l2(y_card, y_cpu)
    wide = llama.LlamaConfig(**{**cfg.__dict__, "capacity_factor": float(e)})
    y_cap = llama._moe_mlp_capacity(wide, card_p, xc)
    y_dense = llama._moe_mlp_dense(wide, card_p, xc)
    rel_dense = rel_l2(y_cap, y_dense)
    tol = 1e-4
    ok = (same_slots and drops["cpu"] == drops["cuda"] > 0 and rel <= tol
          and rel_dense <= tol and bool(torch.isfinite(y_card).all()))
    emit({"phase": "moe_layer_card_vs_cpu", "card": card(), "tokens": 1024,
          "d_model": d, "d_ff": f, "n_experts": e, "top_k": cfg.top_k,
          "capacity": capacity, "same_slots": same_slots,
          "dropped_choices": drops, "rel_l2_card_vs_cpu": rel,
          "wide_capacity": llama.moe_capacity(wide, x.shape[1]),
          "rel_l2_capacity_vs_dense_no_drops": rel_dense, "tol": tol,
          "cpu_seconds": cpu_s, "ok": ok})
    if not ok:
        raise AssertionError(f"MoE layer card vs CPU: slots {same_slots}, "
                             f"drops {drops}, rel {rel}, dense {rel_dense}")
    del card_p, y_card, y_cap, y_dense
    torch.cuda.empty_cache()


def phase_exactness_f32_2layer_moe():
    """The 1B-MoE widths at 2 layers in f32 (TF32 off) with dense expert
    dispatch, where a token's output depends on the token alone: the
    engine against greedy_generate and every engine path against the one
    it must reproduce (exactness_f32_engine_paths), by the near-tie rule.
    Then the capacity impl at capacity factor 8 (nothing can drop) serves
    the same prompts: its tokens equal the dense impl's, by the same rule.
    Under capacity routing with drops these equalities do not hold, in
    the JAX package either: a row's length and padding choose what
    drops."""
    cfg = moe_1b_config(n_layers=2, dtype="float32", moe_impl="dense")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = llama.init_params(cfg, g, device="cuda")
    kw = dict(slots=8, max_len=288, chunk_tokens=32, prompt_buckets=(64, 128),
              device="cuda")
    prompts = exactness_prompts()
    new_tokens = 32
    lanes = [{}] * len(prompts)
    streams, _ = serve(decode_engine.RaggedDecoder(params, cfg, **kw), prompts,
                       new_tokens, lanes)
    greedy = [s.tokens for s in streams]
    divs = []
    for p, toks in zip(prompts, greedy):
        ref = llama.greedy_generate(params, torch.from_numpy(p[None]).cuda(),
                                    cfg, new_tokens)[0, len(p):].tolist()
        i, margin = assert_tokens_agree(toks, ref,
                                        stream_scores(params, cfg, p, toks))
        if i is not None:
            divs.append({"at": i, "margin": margin})
    emit({"phase": "exactness_f32_2layer_moe", "check": "engine_vs_greedy_generate",
          "card": card(), "moe_impl": "dense", "streams": len(prompts),
          "divergences": divs, "near_tie_tol": NEAR_TIE_TOL, "ok": True})
    exactness_f32_engine_paths(cfg, params, prompts, greedy, new_tokens,
                               tag="exactness_f32_2layer_moe")
    cap_cfg = llama.LlamaConfig(**{**cfg.__dict__, "moe_impl": "capacity",
                                   "capacity_factor": 8.0})
    streams, _ = serve(decode_engine.RaggedDecoder(params, cap_cfg, **kw),
                       prompts, new_tokens, lanes)
    divs, equal = [], 0
    for p, s, want in zip(prompts, streams, greedy):
        i, margin = assert_tokens_agree(
            s.tokens, want, stream_scores(params, cfg, p, s.tokens))
        equal += i is None
        if i is not None:
            divs.append({"at": i, "margin": margin})
    emit({"phase": "exactness_f32_2layer_moe",
          "check": "capacity_factor_8_vs_dense", "card": card(),
          "streams": len(prompts), "equal_streams": equal,
          "divergences": divs, "near_tie_tol": NEAR_TIE_TOL, "ok": True})
    del params
    torch.cuda.empty_cache()


def phase_serving_moe_tiny_server():
    """LLMServer("moe-tiny", device="cuda"), the MoE model build_model
    names (bf16, 4 experts, top-2, vocab 32128): 8 requests from 4
    handler threads, half by generate() and half streamed; its tokens
    equal a bare RaggedDecoder's on the same weights (near-tie rule), no
    pump error is logged and shutdown drains."""
    rng = np.random.RandomState(SEED + 12)
    prompts = [rng.randint(1, 30000, 24).astype(np.int32) for _ in range(8)]
    kw = dict(slots=4, max_len=96, chunk_tokens=8, prompt_buckets=(32,))
    errors = PumpErrors()
    port_log = logging.getLogger("ray_tpu_torch")
    port_log.addHandler(errors)
    try:
        fa.reset_launch_count()
        srv = serve_llm.LLMServer("moe-tiny", seed=SEED, device="cuda", **kw)
        results, dt, _, _, _ = serve_through_server(
            srv, prompts, 32, lambda k: None, concurrency=4)
        counts = fa.launch_counts()
        drained = srv.shutdown(30)
    finally:
        port_log.removeHandler(errors)
    params, cfg = srv.engine.params, srv.cfg
    bare, _ = serve(decode_engine.RaggedDecoder(params, cfg, device="cuda", **kw),
                    prompts, 32, [{}] * len(prompts))
    divs = []
    for p, r, s in zip(prompts, results, bare):
        i, margin = assert_tokens_agree(r["tokens"], s.tokens,
                                        stream_scores(params, cfg, p, r["tokens"]))
        if i is not None:
            divs.append({"at": i, "margin": margin})
    ok = not errors.records and drained and not any(counts.values()) \
        and cfg.n_experts == 4
    emit({"phase": "serving_moe_tiny_server", "card": card(),
          "requests": len(prompts), "handler_threads": 4,
          "n_experts": cfg.n_experts, "dtype": cfg.dtype, "seconds": dt,
          "server_tokens_per_sec": len(prompts) * 32 / dt,
          "equal_to_bare_engine": len(prompts) - len(divs),
          "divergences": divs, "flash_launches": counts, "drained": drained,
          "pump_errors": errors.records, "ok": ok})
    if not ok:
        raise AssertionError(f"moe-tiny server: pump errors {errors.records}, "
                             f"drained {drained}, launches {counts}")
    return counts


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
    MFU is 6 x num_params x tokens/s over the peak (bench.py's); for a
    MoE model, whose num_params counts every expert for every token, it
    is 3 x the forward's products (moe_forward_flops: the forward and a
    backward of twice its products, remat's recompute not counted) over
    the step time. Returns the launches of all steps."""
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
    if cfg.n_experts:
        mfu = 3 * moe_forward_flops(cfg, batch, seq) / (step_ms / 1e3) / peaks[0]
        mfu_basis = "3 x forward products (moe_forward_flops)"
    else:
        mfu, mfu_basis = 6.0 * n_params * tps / peaks[0], "6 x num_params"
    bad_counts = [c for c in per_step if c != expect]
    ok = (all(np.isfinite(losses)) and np.isfinite(final)
          and final < losses[0] and not bad_counts)
    emit({"phase": tag, "size": f"{cfg.d_model}d x {cfg.n_layers}L",
          "n_params": n_params, "batch": batch, "seq": seq,
          "remat_policy": cfg.remat_policy, "grads_dtype": "bfloat16",
          "warm_steps": warm, "warm_seconds": warm_s, "timed_steps": timed,
          "step_ms": step_ms, "tokens_per_sec": tps,
          "mfu": mfu, "mfu_basis": mfu_basis,
          "mfu_peak_flops": peaks[0], "card": card(),
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


def phase_mesh_dryrun_card():
    """ray_tpu_torch.multichip.dryrun_multichip(1): one sharded train step
    of the tiny dry-run model in a world of one rank (a spawned process,
    NCCL, this card). n = 1 is odd, so only the first layout runs, as in
    JAX. Its rank prints the dryrun_multichip ok line."""
    t0 = time.perf_counter()
    losses = multichip.dryrun_multichip(1)
    ok = len(losses) == 1 and bool(np.all(np.isfinite(losses)))
    emit({"phase": "mesh_dryrun_card", "world": 1, "backend": "nccl",
          "losses": losses, "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        raise AssertionError(f"mesh dry run: losses {losses}")


def mesh_train_step(cfg, mesh):
    """train_setup's state and step on ``mesh``: the same seeded params
    (every leaf a DTensor by the default rules), optimizer and bf16
    gradients, through init_train_state / make_train_step's mesh forms."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 200)
    opt = train.fused_adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16,
                            nu_dtype=torch.bfloat16)
    state, state_sh = train.init_train_state(
        lambda dev, place: llama.init_params(cfg, g, dev, master=True,
                                             place=place),
        llama.param_logical_axes(cfg), opt, mesh)
    step = train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt,
                                 mesh, state_sh, compute_grad_norm=False,
                                 grads_dtype=torch.bfloat16)
    return state, step


def run_steps(step, state, data, n, expect, tag):
    """n steps between CUDA events: (state, losses, step ms, launches of the
    last step); every step must launch exactly ``expect``."""
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fa.reset_launch_count()
        state, metrics = step(state, data)
        counts = fa.launch_counts()
        if counts != expect:
            raise AssertionError(f"{tag}: a step launched {counts}, "
                                 f"expected {expect}")
        losses.append(metrics["loss"])
    end.record()
    end.synchronize()
    return state, [float(x) for x in losses], start.elapsed_time(end) / n, counts


def phase_train_1b_mesh(expect):
    """The slice's path at full width: train_1b's configuration (Llama-1B,
    B2 x T2048, flash_qkv, bf16 gradients and moments) through the mesh
    forms of init_train_state and make_train_step on a world-1 DeviceMesh
    (all six axes of size 1, NCCL, DEFAULT_RULES), so every leaf and
    activation is a DTensor and the flash kernels launch on the local
    blocks. Held against the one-device step on the same params and
    batch: the losses of steps 1 and 2 within rel 1e-3 and the largest
    param difference after them (printed, with whether it is bit-equal,
    beside the same for a second one-device run); every step launches
    `expect`. Then 3 more mesh steps are timed (CUDA
    events) beside train_1b's step time in this run, with the mesh
    step's peak memory (the one-device state freed first)."""
    cfg = train_config("1b", "flash_qkv")

    def one_device_params():
        plain, plain_step, data = train_setup(cfg, 2, 2048)
        plain, losses, _, _ = run_steps(plain_step, plain, data, 2, expect,
                                        "train_1b (one device)")
        params = [x.cpu() for x in tree_leaves(plain.params)]
        del plain, plain_step
        torch.cuda.empty_cache()
        return params, losses, data

    def max_diff(got, want):
        diff, equal = 0.0, True
        for a, b in zip(got, want):
            a, b = a.cuda(), b.cuda()
            diff = max(diff, float((a - b).abs().max()))
            equal = equal and bool(torch.equal(a, b))
        return diff, equal

    plain_params, plain_losses, data = one_device_params()
    # the same two one-device steps again: the fused backward adds dq
    # by f32 atomics, in an order that changes from run to run
    rerun_diff, rerun_equal = max_diff(one_device_params()[0], plain_params)
    launch.init_process(0, 1, "cuda")
    try:
        mesh = build_mesh(MeshConfig())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, step = mesh_train_step(cfg, mesh)
        init_s = time.perf_counter() - t0
        state, mesh_losses, first_ms, _ = run_steps(step, state, data, 2, expect,
                                                    "train_1b_mesh")
        diff, equal = max_diff([x.to_local() for x in tree_leaves(state.params)],
                               plain_params)
        placements = sorted({str(tuple(x.placements)) for x in
                             tree_leaves(state.params)})
        state, _, mesh_ms, counts = run_steps(step, state, data, 3, expect,
                                              "train_1b_mesh")
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        del state, step
    finally:
        dist.destroy_process_group()
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh_losses, plain_losses)]
    ok = max(rel) <= 1e-3 and all(np.isfinite(mesh_losses))
    emit({"phase": "train_1b_mesh", "world": 1, "mesh": "1chip",
          "placements": placements, "losses": mesh_losses,
          "one_device_losses": plain_losses, "loss_rel_diff": rel,
          "loss_rel_tol": 1e-3, "max_param_diff_after_2_steps": diff,
          "params_bit_equal": equal,
          "one_device_rerun_max_param_diff": rerun_diff,
          "one_device_rerun_bit_equal": rerun_equal, "init_seconds": init_s,
          "first_two_steps_ms": first_ms, "step_ms": mesh_ms,
          "train_1b_step_ms": RECORDS.get("train_1b", {}).get("step_ms"),
          "max_allocated_gb": peak_gb, "launches_per_step": counts,
          "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"train_1b_mesh: losses {mesh_losses} against "
                             f"{plain_losses}")
    torch.cuda.empty_cache()
    return {k: 5 * v for k, v in counts.items()}


def phase_seq_parallel_card():
    """ring_attention and ulysses_attention in a world of one rank (sp = 1)
    on the 1B attention shape (B2, 16/8 heads, T 2048, bf16, causal),
    each against the flash kernel's plain version. Ulysses at sp = 1 is
    ops.attention: it must launch flash_fwd_sm90. Returns the launches of
    the Ulysses call."""
    q, k, v = flash_inputs(2, 16, 8, 2048, 2048, 128, torch.bfloat16, SEED + 700)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)[0].transpose(1, 2)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    launch.init_process(0, 1, "cuda")
    try:
        mesh = build_mesh(MeshConfig())
        with torch.no_grad():
            ring = ring_attention.ring_attention(qs, ks, vs, mesh)
            fa.reset_launch_count()
            uly = ulysses.ulysses_attention(qs, ks, vs, mesh=mesh)
            counts = fa.launch_counts()
    finally:
        dist.destroy_process_group()
    err = {name: float((x.float() - want.float()).abs().max())
           for name, x in (("ring", ring), ("ulysses", uly))}
    tol = TOL[torch.bfloat16]["out"]
    ok = max(err.values()) <= tol and counts == expected(flash_fwd_sm90=1)
    emit({"phase": "seq_parallel_card", "world": 1, "sp": 1,
          "shape": [2, 2048, 16, 8, 128], "dtype": "bfloat16",
          "max_abs_err_vs_plain": err, "tol": tol, "ulysses_launches": counts,
          "ok": ok})
    if not ok:
        raise AssertionError(f"seq_parallel_card: errors {err}, launches "
                             f"{counts}")
    return counts


def phase_pipeline_gpipe_card():
    """pipeline_apply in a world of one rank (NCCL, pp = 1) over the 1B
    layer stack (bf16) on one B1 x T2048 batch, against the plain loop
    over the layers on the same input: at one stage the function is that
    loop, so the two must be bit-equal, and the 22 layers launch 22
    flash_fwd_sm90. GPipe at pp > 1 needs one card a rank (NCCL) and ran
    only over gloo on the CPU. Returns the pipeline call's launches."""
    cfg = train_config("1b", "flash_qkv")
    g = torch.Generator(device="cuda").manual_seed(SEED + 800)
    params = llama.init_params(cfg, g, device="cuda")
    toks = torch.from_numpy(np.random.RandomState(SEED + 800).randint(
        0, cfg.vocab_size, (1, 2048))).cuda()
    sin, cos = rotary_embedding(torch.arange(2048, dtype=torch.int32,
                                             device="cuda")[None, :],
                                cfg.head_dim, cfg.rope_theta)

    def layer(h, p):
        return llama._layer(cfg, h, p, sin, cos)

    with torch.no_grad():
        h = llama._embed(params, cfg, toks)
        want = h
        for p in llama._unbind_layers(params):
            want = layer(want, p)
        launch.init_process(0, 1, "cuda")
        try:
            mesh = build_mesh(MeshConfig())
            fa.reset_launch_count()
            with use_mesh(mesh):
                stages = pipeline_stages()
                got = pipeline_apply(layer, params["layers"], h,
                                     num_microbatches=1)
            counts = fa.launch_counts()
        finally:
            dist.destroy_process_group()
    diff = float((got.float() - want.float()).abs().max())
    equal = bool(torch.equal(got, want))
    ok = stages == 1 and equal and counts == expected(flash_fwd_sm90=cfg.n_layers)
    emit({"phase": "pipeline_gpipe_card", "world": 1, "pp": stages,
          "shape": [1, 2048, cfg.d_model], "layers": cfg.n_layers,
          "max_abs_diff_vs_layer_loop": diff, "bit_equal": equal,
          "launches": counts,
          "pp_gt_1": "run only on the CPU over gloo (tests/test_torch_pipeline.py"
                     ", tests/test_torch_multichip.py): NCCL takes one card a "
                     "rank and this machine has one",
          "ok": ok})
    if not ok:
        raise AssertionError(f"pipeline_gpipe_card: pp={stages}, diff {diff}, "
                             f"launches {counts}")
    del params, got, want, h
    torch.cuda.empty_cache()
    return counts


MPMD_M, MPMD_STEPS, MPMD_LR, MPMD_SPLIT = 4, 3, 1e-4, 11


def mpmd_data(step, m, vocab=32128, seq=2048):
    """Microbatch m of step `step`: seeded tokens [1, seq + 1] as (inputs,
    targets), host numpy."""
    toks = np.random.RandomState(SEED + 900 + 10 * step + m).randint(
        0, vocab, (1, seq + 1)).astype(np.int64)
    return toks[:, :-1], toks[:, 1:]


def _fresh(params):
    """New leaves of ``params`` that require grad (the stage's graph)."""
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    return leaves, tree_unflatten(params, leaves)


def mpmd_llama_stages(cfg, full, split):
    """The pipeline's user code: two StageSpecs over Llama's blocks, on the
    card. Stage 0 holds the embedding and layers [0, split), stage 1 the
    rest, the final norm, the head and the loss. The boundary carries the
    bf16 hidden state as f32 host numpy (exact both ways); each stage's
    saved value keeps its autograd graph."""
    cdt, dev = cfg.compute_dtype, full["embed"].device
    layer_fn = llama._remat_layer_fn(cfg)
    trees = ({"embed": full["embed"].clone(),
              "layers": {k: v[:split].clone() for k, v in full["layers"].items()}},
             {"layers": {k: v[split:].clone() for k, v in full["layers"].items()},
              "final_norm": full["final_norm"].clone(),
              "lm_head": full["lm_head"].clone()})

    def layers(p, h):
        sin, cos = rotary_embedding(torch.arange(
            h.shape[1], dtype=torch.int32, device=dev)[None, :],
            cfg.head_dim, cfg.rope_theta)
        for lp in llama._unbind_layers(p):
            h = layer_fn(h, lp, sin, cos)
        return h

    def forward0(params, x):
        leaves, p = _fresh(params)
        h = layers(p, llama._embed(p, cfg, torch.from_numpy(x).to(dev)))
        return h.detach().float().cpu().numpy(), (leaves, h)

    def backward0(params, saved, dy):
        leaves, h = saved
        grads = torch.autograd.grad(h, leaves, torch.from_numpy(dy).to(dev, cdt))
        return None, tree_unflatten(params, list(grads))

    def forward1(params, x):
        leaves, p = _fresh(params)
        h_in = torch.from_numpy(x).to(dev, cdt).requires_grad_()
        h = rms_norm(layers(p, h_in), p["final_norm"], cfg.rms_eps)
        logits = h @ p["lm_head"].to(cdt)
        return logits, (leaves, h_in, logits)

    def loss1(params, y, target):
        loss, _ = softmax_cross_entropy(y, torch.from_numpy(target).to(dev))
        dy, = torch.autograd.grad(loss, y)
        return float(loss.detach()), dy

    def backward1(params, saved, dy):
        leaves, h_in, logits = saved
        grads = torch.autograd.grad(logits, [h_in] + leaves, dy)
        return (grads[0].float().cpu().numpy(),
                tree_unflatten(params, list(grads[1:])))

    return [StageSpec(1, lambda c: trees[0], forward0, backward0),
            StageSpec(1, lambda c: trees[1], forward1, backward1, loss1)]


def mpmd_reference(cfg, full, data_fn=mpmd_data):
    """The sequential one-device run of the pipeline's steps: llama.loss_fn
    per microbatch, gradients summed in ascending microbatch order, times
    1/M, the same SGD update. Returns (mean losses, step ms, params)."""
    params, losses, step_ms = full, [], []
    dev = full["embed"].device
    for step in range(MPMD_STEPS):
        t0 = time.perf_counter()
        leaves, p = _fresh(params)
        acc, ls = None, []
        for m in range(MPMD_M):
            x, t = data_fn(step, m)
            loss, _ = llama.loss_fn(p, {"inputs": torch.from_numpy(x).to(dev),
                                        "targets": torch.from_numpy(t).to(dev)},
                                    cfg)
            g = torch.autograd.grad(loss, leaves)
            acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
            ls.append(float(loss.detach()))
        with torch.no_grad():
            params = tree_unflatten(params, [
                (x - MPMD_LR * (g * (1.0 / MPMD_M))).to(x.dtype)
                for x, g in zip(tree_leaves(params), acc)])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(sum(ls) / len(ls))
    return losses, step_ms, params


class SpanLog:
    """The pipeline's spans, kept."""

    def __init__(self):
        self.spans = []
        self.lock = threading.Lock()

    def record(self, cat, name, t0, t1, attrs=None):
        with self.lock:
            self.spans.append((name, t0, t1, dict(attrs or {})))


def phase_pipeline_mpmd_1b():
    """The slice's path at full width: Llama-1B (train_1b's configuration:
    bf16 compute, f32 params, remat flash_qkv) as a two-stage MPMD pipeline
    (MpmdPipeline on InProcessPipelineRuntime: a thread and a CUDA stream
    per stage, both on this card; stage 0 the embedding and layers 0-10,
    stage 1 layers 11-21, the final norm, the head and the loss), 1F1B, M
    = 4 microbatches of B1 x T2048 a step, 3 steps of SGD at lr 1e-4.
    Held against the sequential one-device run of the same steps (the
    losses within rel 1e-3; the largest param difference printed: the
    fused backward adds dq by atomics, so bits differ); every step
    launches 88 flash_fwd_sm90 and 88 flash_bwd_fused_sm90 (22 layers x 4
    microbatches); no heal, no gang restart. Prints the step time beside
    the reference's, each stage's measured bubble beside the analytic
    (S-1)/(M+S-1), the boundary bytes a step and the peak memory."""
    cfg = train_config("1b", "flash_qkv")
    g = torch.Generator(device="cuda").manual_seed(SEED + 900)
    full = llama.init_params(cfg, g, device="cuda", master=True)
    spans = SpanLog()
    runtime = InProcessPipelineRuntime(spans)
    pipe = MpmdPipeline(mpmd_llama_stages(cfg, full, MPMD_SPLIT),
                        data_fn=mpmd_data, num_steps=MPMD_STEPS,
                        microbatches=MPMD_M, schedule="1f1b", lr=MPMD_LR,
                        return_params=True, runtime=runtime, poll_s=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    t0 = time.perf_counter()
    res = pipe.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_spans = {s: [(t1 - t0_) * 1e3 for name, t0_, t1, a in spans.spans
                      if name == "pipeline.step" and a["stage"] == s]
                  for s in (0, 1)}
    got = [x for tree in res.final_params for x in tree_leaves(tree)]
    res.final_params = None
    ref_losses, ref_ms, ref_params = mpmd_reference(cfg, full)
    want = [x for tree in (
        {"embed": ref_params["embed"],
         "layers": {k: v[:MPMD_SPLIT] for k, v in ref_params["layers"].items()}},
        {"layers": {k: v[MPMD_SPLIT:] for k, v in ref_params["layers"].items()},
         "final_norm": ref_params["final_norm"], "lm_head": ref_params["lm_head"]})
        for x in tree_leaves(tree)]
    diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel = [abs(a - b) / abs(b) for a, b in zip(res.losses, ref_losses)]
    per_step = expected(flash_fwd_sm90=cfg.n_layers * MPMD_M,
                        flash_bwd_fused_sm90=cfg.n_layers * MPMD_M)
    total = {k: MPMD_STEPS * v for k, v in per_step.items()}
    analytic = (2 - 1) / (MPMD_M + 2 - 1)
    ok = (len(res.losses) == MPMD_STEPS and all(np.isfinite(res.losses))
          and max(rel) <= 1e-3 and counts == total and res.heals == 0
          and res.gang_restarts == 0)
    emit({"phase": "pipeline_mpmd_1b", "stages": 2, "split": [MPMD_SPLIT, 22],
          "schedule": "1f1b", "microbatches": MPMD_M, "microbatch": [1, 2048],
          "steps": MPMD_STEPS, "lr": MPMD_LR, "losses": res.losses,
          "reference_losses": ref_losses, "loss_rel_diff": rel,
          "loss_rel_tol": 1e-3, "max_param_diff_after_3_steps": diff,
          "launches": counts, "expected_launches": total,
          "heals": res.heals, "gang_restarts": res.gang_restarts,
          "fit_seconds": fit_s, "stage_step_ms": step_spans,
          "step_ms": float(np.mean(step_spans[0][1:])),
          "reference_step_ms": ref_ms,
          "reference_step_ms_mean": float(np.mean(ref_ms[1:])),
          "bubble_by_stage": res.bubble_by_stage,
          "bubble_analytic": analytic,
          "boundary_bytes_per_step": runtime.bytes_sent / MPMD_STEPS,
          "max_allocated_gb": peak_gb, "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"pipeline_mpmd_1b: losses {res.losses} against "
                             f"{ref_losses}, launches {counts} (expected "
                             f"{total}), heals {res.heals}")
    del full, ref_params, got, want
    torch.cuda.empty_cache()
    return counts


TRAINER_STEPS, TRAINER_SAVE_STEP, TRAINER_KILL_STEP = 4, 2, 3
TRAINER_BLOCKS = 8  # seeded token blocks of B2 x T2049, 4 a worker
TRAINER_BUCKET = 64 * 2**20  # dcn_allreduce_grads bucket bytes


def trainer_blocks():
    """The trainer's dataset: TRAINER_BLOCKS seeded token blocks, each one
    worker's batch for one step (B2 x T2048 inputs and targets)."""
    out = []
    for i in range(TRAINER_BLOCKS):
        toks = np.random.RandomState(SEED + 1100 + i).randint(
            0, 32128, (2, 2049)).astype(np.int64)
        out.append(torch.from_numpy(toks))
    return out


def state_checksums(state, chunk=2**26) -> list:
    """Per leaf of a train state (or any tree), on the card: the sum of
    its bit patterns and their sum weighted by (index mod 997) + 1, as
    int64 wrapping (the step counters as they are), taken `chunk`
    elements at a time. Equal lists mean equal bits, bar a collision."""
    out = []
    leaves, _ = ckpt_mod._flatten(state)
    for x in leaves:
        if not isinstance(x, torch.Tensor):
            out.append(int(np.asarray(x)))
            continue
        flat = x.detach().reshape(-1).view(
            torch.int16 if x.element_size() == 2 else torch.int32)
        s0 = torch.zeros((), dtype=torch.int64, device=flat.device)
        s1 = torch.zeros_like(s0)
        for a in range(0, flat.numel(), chunk):
            bits = flat[a:a + chunk].to(torch.int64)
            w = torch.arange(a, a + bits.numel(), device=bits.device) % 997 + 1
            s0 += bits.sum()
            s1 += (bits * w).sum()
            del bits, w
        out.append([int(s0), int(s1)])
    return out


def trainer_loop(config):
    """One worker of the train_1b_trainer phase (a thread of this process
    with its own CUDA stream): train_1b's step on its own DataShard, the
    gradients averaged across the gang by dcn_allreduce_grads every step;
    rank 0 saves the whole state after step TRAINER_SAVE_STEP; with
    config["kill"], worker 1 exits halfway through step
    TRAINER_KILL_STEP's gradient sync. A resumed worker restores the
    checkpoint onto the card and its data cursor from it. What is
    measured goes to config["probe"] (shared by the threads): per step
    the block the worker consumed and its params' checksums (taken after
    the report, so in the next step's compute segment), and with
    config["kill"] the raw and the synced gradients of step 1's bucket
    with the most leaves, on the host."""
    from ray_tpu_torch.train import session

    cfg, probe, dev = config["cfg"], config["probe"], config["device"]
    rank, seq = session.get_world_rank(), session.get_resume_seq()
    group = session.get_collective_group()
    opt = train.fused_adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16,
                            nu_dtype=torch.bfloat16)
    ck = session.get_checkpoint()
    shard = session.get_dataset_shard("train")
    if ck is None:
        g = torch.Generator(device=dev).manual_seed(SEED + 1000)
        state = train.init_train_state(
            lambda d: llama.init_params(cfg, g, d, master=True), opt, device=dev)
    else:
        stats = {}
        t0 = time.perf_counter()
        state = train.restore_state(ck.path, device=dev, stats=stats)
        if dev == "cuda":
            torch.cuda.current_stream().synchronize()
        restore_s = time.perf_counter() - t0
        shard.load_state(ck.to_dict()["cursor"])
        probe[("restored", seq, rank)] = {
            "seconds": restore_s, "bytes_read": stats["bytes_read"],
            "checksums": state_checksums(state), "step": state.step}
    buckets = list(dcn._fill_buckets(
        [torch.empty(p.shape, dtype=torch.bfloat16, device="meta")
         for p in ckpt_mod._flatten(state.params)[0]], TRAINER_BUCKET))
    n_buckets = len(buckets)
    held = [i for i, _, _ in max(buckets, key=lambda b: len(b[2]))[2]]
    if config["kill"] and seq == 0 and rank == 1:
        # each step makes n_buckets gradient calls and one cursor call
        fault_injection.configure([{
            "site": "collective.allreduce", "match": {"rank": 1},
            "after": (TRAINER_KILL_STEP - 1) * (n_buckets + 1) + n_buckets // 2,
            "count": 1, "action": "exit"}])
    def sync(grads):
        synced = train.dcn_allreduce_grads(grads, group,
                                           bucket_bytes=TRAINER_BUCKET)
        if config["kill"] and seq == 0 and state.step == 0:
            raw = ckpt_mod._flatten(grads)[0]
            out = ckpt_mod._flatten(synced)[0]
            probe[("bucket", rank)] = ([raw[i].float().cpu() for i in held],
                                       [out[i].cpu() for i in held])
        return synced

    step = train.make_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt, compute_grad_norm=False,
        grads_dtype=torch.bfloat16, device=dev, sync_grads=sync)
    blocks = iter(shard)
    while state.step < TRAINER_STEPS:
        before = set(shard.state()["consumed"])
        toks = next(blocks).to(dev, non_blocking=True)
        (block,) = set(shard.state()["consumed"]) - before
        state, metrics = step(state, {"inputs": toks[:, :-1],
                                      "targets": toks[:, 1:]})
        onehot = np.zeros(TRAINER_BLOCKS, np.float32)
        onehot[shard.state()["consumed"]] = 1
        consumed = train.dcn_allreduce_grads({"c": onehot}, group, op="sum")["c"]
        ckpt = None
        if rank == 0 and state.step == TRAINER_SAVE_STEP:
            probe[("saved", seq)] = state_checksums(state)
            t0 = time.perf_counter()
            ckpt = train.save_state(state, os.path.join(
                config["ck_dir"], f"step{state.step}"), extra={"cursor": {
                    "epoch": shard.epoch,
                    "consumed": [int(i) for i in np.nonzero(consumed)[0]]}})
            probe[("save", seq)] = {"seconds": time.perf_counter() - t0,
                                    "bytes": sum(os.path.getsize(os.path.join(
                                        ckpt.path, f)) for f in os.listdir(ckpt.path))}
        session.report({"step": state.step, "loss": float(metrics["loss"]),
                        "n_buckets": n_buckets}, checkpoint=ckpt)
        probe[("block", seq, rank, state.step)] = block
        probe[("params", seq, rank, state.step)] = state_checksums(state.params)


def step_segments(spans) -> list:
    """Each train.step span as its ms by segment (session._close_step's
    breakdown: compute is the step's wall less its waits)."""
    return [{"rank": a["rank"], "step": a["step"], "resume_seq": a["resume_seq"],
             "ms": 1e3 * (t1 - t0), "compute_ms": 1e3 * a["compute_s"],
             "collective_ms": 1e3 * a["collective_wait_s"],
             "checkpoint_ms": 1e3 * a["checkpoint_s"],
             "data_ms": 1e3 * a["data_wait_s"]}
            for name, t0, t1, a in spans.spans if name == "train.step"]


def run_trainer(cfg, kill, ck_dir, device="cuda"):
    """A Trainer(backend="dcn") of 2 workers on the in-process gang; returns
    (result, probe, spans, flash launches)."""
    spans, probe = SpanLog(), {}
    trainer = train.Trainer(
        trainer_loop,
        train_loop_config={"cfg": cfg, "probe": probe, "kill": kill,
                           "ck_dir": ck_dir, "device": device},
        scaling_config=train.ScalingConfig(num_workers=2, backend="dcn",
                                           max_restarts=1),
        run_config=train.RunConfig(name="train_1b_trainer",
                                   storage_path=ck_dir, max_failures=0),
        datasets={"train": trainer_blocks()},
        runtime=InProcessTrainRuntime(spans))
    fault_injection.clear()
    fa.reset_launch_count()
    result = trainer.fit()
    if device == "cuda":
        torch.cuda.synchronize()
    counts = fa.launch_counts()
    fault_injection.clear()
    return result, probe, spans, counts


def phase_train_1b_trainer():
    """The train runtime's path at full width and depth: Trainer(backend=
    "dcn") with 2 workers on the in-process gang (threads with a CUDA
    stream each, both on this card), max_restarts=1. Each worker runs
    train_1b's step (Llama-1B, remat flash_qkv, B2 x T2048, bf16 gradients
    and moments, fused_adamw) on its DataShard of seeded token blocks,
    the gradients averaged every step by dcn_allreduce_grads through the
    host. Rank 0 saves the train state with save_state after step 2;
    worker 1 exits during step 3's gradient sync; the trainer resumes in
    place (worker 1 respawned, both restore the step-2 checkpoint onto
    the card and their data cursors from it) and finishes steps 3-4. Then
    the same trainer runs 4 steps with no fault. Checks: resumes
    {"inplace": 1, "gang": 0}; every restored state's per-leaf checksums
    equal those taken before the save; the losses of steps 3-4 within
    rel 1e-3 of the unfaulted run's (the fused backward's dq atomics);
    step 1's synced bucket with the most leaves, as both workers got it on
    the card, bit-equal to the host mean of their raw gradients; after
    every step the two workers' params bit-equal; the block each worker
    consumed at each step the unfaulted run's; 22 + 22 flash launches
    per worker per step. After the faulted run, rank 0's newest
    checkpoint is shipped through an in-process runtime and fetched into a
    fresh directory (ship_and_fetch): verified, and byte-equal to the
    source."""
    cfg = train_config("1b", "flash_qkv")
    ck_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "train_1b_trainer")
    shutil.rmtree(ck_root, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, probe, spans, counts = run_trainer(cfg, True, os.path.join(ck_root, "a"))
    fault_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if res.error is not None:
        raise AssertionError(f"train_1b_trainer: {res.error}")
    # rank 0's newest checkpoint, shipped through the in-process store and
    # fetched into a fresh directory
    shipped = ship_and_fetch(res.checkpoint.path, os.path.join(ck_root, "fetched"))
    shutil.rmtree(os.path.join(ck_root, "fetched"))
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ref, ref_probe, ref_spans, ref_counts = run_trainer(
        cfg, False, os.path.join(ck_root, "b"))
    ref_s = time.perf_counter() - t1
    ref_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    shutil.rmtree(ck_root, ignore_errors=True)
    losses = [m["loss"] for m in res.metrics_history]
    ref_losses = [m["loss"] for m in ref.metrics_history]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    saved = probe[("saved", 0)]
    restored = {f"rank{k[2]}": v for k, v in probe.items() if k[0] == "restored"}
    bit_equal = bool(restored) and all(v["checksums"] == saved
                                       for v in restored.values())
    # the dcn sync on the card against the plain host mean of the two
    # workers' raw gradients (f32 sum, one rounding to bf16: exact)
    (raw0, got0), (raw1, got1) = probe[("bucket", 0)], probe[("bucket", 1)]
    want_mean = [((a + b) / 2).to(torch.bfloat16) for a, b in zip(raw0, raw1)]
    sync_exact = all(torch.equal(w, g0) and torch.equal(w, g1)
                     for w, g0, g1 in zip(want_mean, got0, got1))
    sync_elems = sum(w.numel() for w in want_mean)
    del raw0, got0, raw1, got1, want_mean

    def per_step(pr, kind):
        """(rank, step) -> the value the run that finished that step
        recorded (a resumed attempt overrides the first)."""
        return {k[2:]: v for k, v in sorted(
            ((k, v) for k, v in pr.items() if k[0] == kind),
            key=lambda kv: kv[0][1])}

    blocks, ref_blocks = per_step(probe, "block"), per_step(ref_probe, "block")
    blocks_match = blocks == ref_blocks and len(blocks) == 2 * TRAINER_STEPS

    def ranks_agree_in(pr):
        sums = {k[1:]: v for k, v in pr.items() if k[0] == "params"}
        return bool(sums) and all(sums.get((seq, 1 - r, st)) == v
                                  for (seq, r, st), v in sums.items())

    ranks_agree = ranks_agree_in(probe) and ranks_agree_in(ref_probe)
    kill_t = [t for name, t, _, _ in spans.spans if name == "worker.killed"]
    first_after = min(t1_ for name, _, t1_, a in spans.spans
                      if name == "train.step" and a["resume_seq"] == 1)
    n1b = cfg.n_layers
    worker_steps = 2 * TRAINER_STEPS + 2  # step 3 ran its backward twice
    want = expected(flash_fwd_sm90=worker_steps * n1b,
                    flash_bwd_fused_sm90=worker_steps * n1b)
    want_ref = expected(flash_fwd_sm90=2 * TRAINER_STEPS * n1b,
                        flash_bwd_fused_sm90=2 * TRAINER_STEPS * n1b)
    rows = step_segments(spans)
    ref_rows = step_segments(ref_spans)
    steady = [r for r in ref_rows if r["step"] > 1]
    ok = (res.resumes == {"inplace": 1, "gang": 0}
          and ref.resumes == {"inplace": 0, "gang": 0}
          and [m["step"] for m in res.metrics_history] == [1, 2, 3, 4]
          and len(restored) == 2 and bit_equal and sync_exact
          and blocks_match and ranks_agree
          and all(np.isfinite(losses)) and max(rel) <= 1e-3
          and counts == want and ref_counts == want_ref
          and shipped["byte_equal"])
    emit({"phase": "train_1b_trainer", "workers": 2, "backend": "dcn",
          "n_params": cfg.num_params(), "batch_per_worker": [2, 2048],
          "steps": TRAINER_STEPS, "save_after_step": TRAINER_SAVE_STEP,
          "kill_during_step": TRAINER_KILL_STEP, "resumes": res.resumes,
          "reference_resumes": ref.resumes, "losses": losses,
          "reference_losses": ref_losses, "loss_rel_diff": rel,
          "loss_rel_tol": 1e-3, "restored_bit_equal": bit_equal,
          "sync_bucket_equals_host_mean": sync_exact,
          "sync_bucket_elements": sync_elems,
          "blocks_by_rank_step": {f"{r}/{st}": b
                                  for (r, st), b in sorted(blocks.items())},
          "blocks_equal_unfaulted": blocks_match,
          "params_equal_across_ranks_every_step": ranks_agree,
          "ship_fetch": shipped,
          "save_seconds": probe[("save", 0)]["seconds"],
          "save_bytes": probe[("save", 0)]["bytes"],
          "restore": {k: {"seconds": v["seconds"], "bytes_read": v["bytes_read"]}
                      for k, v in restored.items()},
          "kill_to_first_resumed_report_s": first_after - kill_t[0],
          "grad_buckets_per_step": res.metrics_history[0]["n_buckets"],
          "bucket_bytes": TRAINER_BUCKET,
          "step_segments": rows,
          "reference_step_segments": ref_rows,
          "reference_step_ms_mean": float(np.mean([r["ms"] for r in steady])),
          "reference_compute_ms_mean": float(np.mean([r["compute_ms"]
                                                     for r in steady])),
          "reference_collective_ms_mean": float(np.mean([r["collective_ms"]
                                                        for r in steady])),
          "one_device_step_ms": RECORDS.get("train_1b", {}).get("step_ms"),
          "launches": counts, "expected_launches": want,
          "reference_launches": ref_counts,
          "faulted_run_seconds": fault_s, "reference_run_seconds": ref_s,
          "max_allocated_gb": peak_gb, "reference_max_allocated_gb": ref_peak_gb,
          "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"train_1b_trainer: resumes {res.resumes}, losses "
                             f"{losses} against {ref_losses}, restored bit-equal "
                             f"{bit_equal}, sync exact {sync_exact}, blocks "
                             f"{blocks} against {ref_blocks}, ranks agree "
                             f"{ranks_agree}, launches {counts} (expected {want}), "
                             f"shipped {shipped}")
    torch.cuda.empty_cache()
    return counts


class Corridor:
    """tests/test_rl.py's corridor env: 5 steps right to the goal (+1),
    -0.05 a step, obs [pos / 5, 1]."""

    N = 5

    def __init__(self):
        self.pos = 0

    def reset(self):
        self.pos = 0
        return self._obs()

    def _obs(self):
        return np.array([self.pos / self.N, 1.0], np.float32)

    def step(self, action):
        self.pos = max(0, self.pos + (1 if action == 1 else -1))
        done = self.pos >= self.N
        return self._obs(), (1.0 if done else -0.05), done, {}


# the largest share of a leaf whose params adam_card_vs_cpu holds only to
# the steps' bound (tests/test_torch_rl.py's assert_adam_step_close)
FLOOR_SHARE = 0.02


def adam_card_vs_cpu(card_params, cpu_params, card_grads, cpu_grads, lr):
    """Card against CPU after len(grads) Adam steps from the same weights
    (f32, TF32 off). Each step's gradient: rtol 1e-5, atol 1e-5 x the
    leaf's largest (sums in another order leave an absolute floor). The
    params: rtol 1e-5, atol 1e-7 wherever every step's gradient stands
    above that floor (|g| > 1e-4 x the leaf's largest) or is 0 at every
    step (the element does not move: BC trains no value head). Below the
    floor Adam's g / (|g| + eps) follows the noise's sign, so there an
    element may miss rtol: it is held to the steps' bound, |delta| <= 2
    lr a step, and at most FLOOR_SHARE (2%) of a leaf may be held so (as
    the CPU tests hold them). The cap counts the elements that miss rtol,
    not all those below the floor: over many steps the floor holds more
    than 2% of a ReLU layer's weights even between identical runs (2.4%
    of SAC's h2 at one step). ``lr``: a float, or the learning rate of a
    leaf's path (SAC's two label groups). Returns (ok, max grad error
    over the leaf's largest, max param error where held at rtol, elements
    that missed rtol, the largest share of a leaf below the floor at one
    step)."""
    lr_of = lr if callable(lr) else (lambda path: lr)
    ok, grad_err, param_err, missed, share = True, 0.0, 0.0, 0, 0.0
    held = {}
    for gc, gk in zip(card_grads, cpu_grads):
        for path, a, b in zip(tree_paths(gk), tree_leaves(gc), tree_leaves(gk)):
            a, b = a.detach().cpu(), b.detach().cpu()
            scale = float(b.abs().max()) or 1.0
            ok &= torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
            grad_err = max(grad_err, float((a - b).abs().max()) / scale)
            above = b.abs() > 1e-4 * scale
            share = max(share, float((~above & (b != 0)).float().mean()))
            live, still = held.get(path, (True, True))
            held[path] = (live & above, still & (b == 0))
    steps = len(card_grads)
    for path, a, b in zip(tree_paths(cpu_params), tree_leaves(card_params),
                          tree_leaves(cpu_params)):
        a, b = a.detach().cpu(), b.detach().cpu()
        live, still = held[path]
        m = live | still
        ok &= torch.allclose(a[m], b[m], rtol=1e-5, atol=1e-7)
        ok &= bool(((a - b).abs() <= 2 * lr_of(path) * steps).all())
        if m.any():
            param_err = max(param_err, float((a[m] - b[m]).abs().max()))
        miss = ~torch.isclose(a, b, rtol=1e-5, atol=1e-7)
        missed += int(miss.sum())
        ok &= float(miss.float().mean()) <= FLOOR_SHARE
    return bool(ok), grad_err, param_err, missed, share


def first_step_grads(state):
    """The gradient of Adam's first step from zero moments: mu / (1 - b1)."""
    return tree_map(lambda m: m / 0.1, state.mu)


def phase_rl_card_vs_cpu():
    """The RL learners' updates on the card against the CPU, from the same
    weights (each seeded init drawn on the CPU) and the same seeded
    batch, in f32 with TF32 off: one Learner.update (PPO loss, 1 epoch, 2
    minibatches of 128 rows), one IMPALA and one APPO update on a
    [T=32, N=4] batch, one BC step, each held by adam_card_vs_cpu with
    their metrics at rtol 1e-5; and VisionPolicyModule.forward_train on
    an 11x13x3 batch (SAME padding on both sides, then at the end), at
    rtol 1e-5, atol 1e-6."""
    rng = np.random.RandomState(SEED + 1200)
    rows = 256
    ppo_batch = {"obs": rng.randn(rows, 8).astype(np.float32),
                 "actions": rng.randint(0, 4, rows).astype(np.int32),
                 "logp": -rng.rand(rows).astype(np.float32) * 1.5,
                 "advantages": rng.randn(rows).astype(np.float32),
                 "returns": rng.randn(rows).astype(np.float32)}
    ppo_batch = rl_learner.normalize_advantages(ppo_batch)
    results, ok_all = {}, True
    # PPO learner: run_sgd with a recording grad hook is Learner.update
    runs = {}
    for dev in ("cuda", "cpu"):
        lrn = rl_learner.Learner(8, 4, lr=3e-4, device=dev)
        grads = []
        metrics = rl_learner.run_sgd(
            lrn, ppo_batch, minibatches=2, epochs=1, shuffle_seed=0,
            grad_hook=lambda g, n: grads.append(g) or g)
        runs[dev] = (lrn, grads, metrics)
    ok, ge, pe, fl, fs = adam_card_vs_cpu(runs["cuda"][0].params,
                                      runs["cpu"][0].params, runs["cuda"][1],
                                      runs["cpu"][1], 3e-4)
    mets = {k: (runs["cuda"][2][k], runs["cpu"][2][k]) for k in runs["cpu"][2]}
    ok &= all(np.isclose(a, b, rtol=1e-5, atol=0) for a, b in mets.values())
    results["learner_update"] = dict(ok=ok, grad_err_over_max=ge,
                                     param_max_abs_err=pe, missed_rtol=fl,
                                     below_floor_share=fs,
                                     metrics=mets)
    ok_all &= ok
    # IMPALA and APPO: one landed batch each
    batch = {"obs": rng.randn(32, 4, 2).astype(np.float32),
             "actions": rng.randint(0, 2, (32, 4)).astype(np.int32),
             "logp": -rng.rand(32, 4).astype(np.float32) * 1.2,
             "values": rng.randn(32, 4).astype(np.float32),
             "rewards": rng.randn(32, 4).astype(np.float32),
             "dones": rng.rand(32, 4) < 0.1,
             "last_values": rng.randn(4).astype(np.float32)}
    for name, config in (("impala", impala.IMPALAConfig), ("appo", appo.APPOConfig)):
        algos, mets = {}, {}
        for dev in ("cuda", "cpu"):
            algo = config(env_creator=Corridor, obs_dim=2, n_actions=2,
                          num_env_runners=1, num_envs_per_runner=2,
                          rollout_steps=8, lr=1e-2).build(device=dev)
            try:
                mets[dev] = algo._apply_batch(algo.batch_to_device(batch))
            finally:
                algo.stop()
            algos[dev] = algo
        ok, ge, pe, fl, fs = adam_card_vs_cpu(
            algos["cuda"].params, algos["cpu"].params,
            [first_step_grads(algos["cuda"].opt_state)],
            [first_step_grads(algos["cpu"].opt_state)], 1e-2)
        m = {k: (float(mets["cuda"][k]), float(mets["cpu"][k]))
             for k in mets["cpu"]}
        ok &= all(np.isclose(a, b, rtol=1e-5, atol=0) for a, b in m.values())
        results[f"{name}_update"] = dict(ok=ok, grad_err_over_max=ge,
                                         param_max_abs_err=pe, missed_rtol=fl,
                                         below_floor_share=fs,
                                         metrics=m)
        ok_all &= ok
    # BC: one step
    obs = rng.randn(128, 4).astype(np.float32)
    acts = rng.randint(0, 2, 128)
    bcs, losses = {}, {}
    for dev in ("cuda", "cpu"):
        algo = bc.BCConfig(lr=1e-3).build(device=dev)
        algo.params, algo.opt_state, loss, acc = algo._update(
            algo.params, algo.opt_state, torch.from_numpy(obs).to(dev),
            torch.from_numpy(acts).to(dev))
        bcs[dev], losses[dev] = algo, (float(loss), float(acc))
    ok, ge, pe, fl, fs = adam_card_vs_cpu(
        bcs["cuda"].params, bcs["cpu"].params,
        [first_step_grads(bcs["cuda"].opt_state)],
        [first_step_grads(bcs["cpu"].opt_state)], 1e-3)
    ok &= bool(np.isclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-5, atol=0))
    ok &= losses["cuda"][1] == losses["cpu"][1]
    results["bc_step"] = dict(ok=ok, grad_err_over_max=ge, param_max_abs_err=pe,
                              missed_rtol=fl, below_floor_share=fs,
                              loss_acc=losses)
    ok_all &= ok
    # the vision module's forward
    mod = rl_module.VisionPolicyModule((11, 13, 3), 6)
    params = mod.init(SEED + 1201, device="cpu")
    x = torch.from_numpy(rng.rand(16, 11, 13, 3).astype(np.float32))
    want = mod.forward_train(params, x)
    got = mod.forward_train(
        {k: {kk: vv.cuda() for kk, vv in v.items()} for k, v in params.items()},
        x.cuda())
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in want}
    ok = all(torch.allclose(got[k].cpu(), want[k], rtol=1e-5, atol=1e-6)
             for k in want)
    results["vision_forward_train"] = dict(ok=ok, max_abs_err=errs)
    ok_all &= ok
    emit({"phase": "rl_card_vs_cpu", "tol": {"rtol": 1e-5, "param_atol": 1e-7,
                                             "grad_atol_over_max": 1e-5,
                                             "missed_share_max": FLOOR_SHARE,
                                             "vision_atol": 1e-6},
          **results, "card": card(), "ok": bool(ok_all)})
    if not ok_all:
        raise AssertionError(f"rl_card_vs_cpu: {results}")


def phase_rl_ppo_corridor():
    """The port's PPO for 3 iterations on the corridor env: 2 in-process
    runners on the CPU, the learner on the card (128 steps a runner an
    iteration, 4 epochs x 4 minibatches). Prints each iteration's seconds
    and the episode-return curve; every metric must be finite."""
    algo = ppo.PPOConfig(env_creator=Corridor, obs_dim=2, n_actions=2,
                         num_env_runners=2, lr=5e-3,
                         entropy_coeff=0.0).build(device="cuda")
    seconds, curve, hist = [], [], []
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            m = algo.train()
            seconds.append(time.perf_counter() - t0)
            curve.append(m["episode_return_mean"])
            hist.append(m)
    finally:
        algo.stop()
    ok = (len(hist) == 3 and algo.learner.device.type == "cuda"
          and all(np.isfinite(v) for m in hist for v in m.values()))
    emit({"phase": "rl_ppo_corridor", "runners": 2, "runner_device": "cpu",
          "learner_device": "cuda", "rollout_steps": 128,
          "seconds_per_iteration": seconds, "episode_return_mean": curve,
          "metrics": hist, "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"rl_ppo_corridor: {hist}")


# one publish and adoption between learner steps is what the loop's
# checks need; the time limit has no room for a third iteration
AL_ITERATIONS = 2
AL_MEAN_RATIO_TOL = 0.05


def phase_actor_learner_1b(runtime=None, iterations=AL_ITERATIONS,
                           tag="actor_learner_1b"):
    """The RL slice's path at full width: ActorLearnerLoop at Llama-1B
    (vocab 32128, bf16 serving, f32 learner masters), max_len 160, one
    pool replica with 8 slots and prompt bucket 64; 8 rollout actors (the
    loop's threads) stream prompts of 64 sampled to 64 new tokens
    (temperature 1); 8 trajectories an iteration, `iterations`
    iterations, one learner (Trainer backend "dcn" on the in-process
    gang), sync mode; default_reward over the model's vocabulary. The
    pool's replica and the buffer are members of `runtime` (None: the
    in-process runtime). Checks:
    no error, a report and a publish an iteration, the pool on the last
    version; buffer conservation
    and exact delivery (every rollout one add, rejection or duplicate;
    added = queued + consumed + dropped; no seq consumed twice); at lag 0
    each iteration's mean importance ratio within AL_MEAN_RATIO_TOL of 1
    (the learner's flash forward at T=128 against the engine's decode
    path, both bf16); 22 flash_fwd_sm90 and 22 flash_bwd_fused_sm90 a
    learner step and no other attention kernel. With a ProcessRuntime
    (a TimedProcessRuntime: phase actor_learner_1b_procs) also: the
    replica and the buffer are
    processes other than this one, which have exited after the loop's
    shutdown, and the flash launches equal actor_learner_1b's for as
    many iterations."""
    ck_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "actor_learner_1b")
    shutil.rmtree(ck_root, ignore_errors=True)
    cfg = actor_learner.ActorLearnerConfig(
        model_size="1b", max_len=160, prompt_len=64, max_new=64,
        n_rollout_actors=8, trajectories_per_iter=8, iterations=iterations,
        num_learners=1, sync_mode=True, storage_path=ck_root,
        reward_fn=functools.partial(actor_learner.default_reward,
                                    vocab_size=actor_learner.VOCAB_SIZE))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = actor_learner.ActorLearnerLoop(
        cfg, pool_kwargs=dict(slots=8, min_replicas=1, max_replicas=1),
        runtime=runtime, device="cuda")
    build_s = time.perf_counter() - t0
    members = [loop.buffer] + [r.handle for r in loop.pool._alive()]
    try:
        fa.reset_launch_count()
        t1 = time.perf_counter()
        out = loop.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        counts = fa.launch_counts()
        adopted = loop.pool.wait_version(iterations, timeout=60.0)
        pool_stats = loop.pool.stats()
    finally:
        loop.shutdown()
        shutil.rmtree(ck_root, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hist = out["result"].metrics_history
    st, ro = out["buffer"], out["rollouts"]
    n1b = llama.llama2_size("1b").n_layers
    want = expected(flash_fwd_sm90=n1b * len(hist),
                    flash_bwd_fused_sm90=n1b * len(hist))
    ratios = [m["mean_ratio"] for m in hist]
    by_version = out["rollout_by_version"]
    iters = []
    for m, pub in zip(hist, out["publish_timing"]):
        ts = m["timing_s"]
        roll = by_version.get(m["version"] - 1, {})
        iters.append({
            "iteration": m["iteration"],
            "rollout_s": roll.get("seconds"),
            "rollout_tokens": roll.get("tokens"),
            "learner_claim_wait_s": ts["claim"],
            "learner_forward_backward_ms": 1e3 * ts["forward_backward"],
            "dcn_allreduce_grads_ms": 1e3 * ts["allreduce"],
            "update_ms": 1e3 * ts["update"],
            "checkpoint_s": ts["checkpoint"],
            "publish_put_s": ts["publish_put"],
            "publish_s": pub["publish_s"], "adoption_s": pub["adoption_s"],
            "mean_reward": m["mean_reward"], "mean_ratio": m["mean_ratio"],
            "logp_gap_mean": m["logp_gap_mean"],
            "logp_gap_max": m["logp_gap_max"], "tokens": m["tokens"],
            "entropy": m["entropy"], "loss": m["loss"]})
    roll_s = sum(by_version[v]["seconds"] for v in range(len(hist)))
    roll_tok = sum(by_version[v]["tokens"] for v in range(len(hist)))
    procs, procs_ok = None, True
    if runtime is not None:
        per_iter = RECORDS["actor_learner_1b"]
        in_process = {k: v * iterations // per_iter["iterations"]
                      for k, v in per_iter["launches"].items()}
        procs = {"runtime": type(runtime).__name__, "parent_pid": os.getpid(),
                 "member_pids": {m.name: m.pid for m in members},
                 "spawn_split": spawn_split(runtime),
                 "puts": len(runtime.puts),
                 "put_gb": sum(b for b, _ in runtime.puts) / 2**30,
                 "put_s": sum(t for _, t in runtime.puts),
                 "exited_after_shutdown": processes_gone(members),
                 "launches_in_process_per_iterations": in_process}
        procs_ok = (os.getpid() not in procs["member_pids"].values()
                    and procs["exited_after_shutdown"]
                    and counts == in_process)
    ok = (procs_ok and out["error"] is None and len(hist) == iterations
          and out["publishes"] == iterations and adopted
          and out["final_version"] == iterations
          and ro["trajectories"] == st["added"] + st["rejected_stale"] + st["dups"]
          and st["added"] == st["queued"] + st["consumed"] + st["dropped_stale"]
          and len(set(st["consumed_seqs"])) == st["consumed"]
          and st["consumed"] == cfg.trajectories_per_iter * iterations
          and all(abs(r - 1.0) <= AL_MEAN_RATIO_TOL for r in ratios)
          and all(np.isfinite(m["loss"]) for m in hist)
          and counts == want)
    emit({"phase": tag, "model": "1b", "vocab": 32128,
          "n_params": serve_llm.model_config("1b", max_len=160,
                                             vocab_size=32128).num_params(),
          "prompt_len": 64, "max_new": 64, "rollout_actors": 8,
          "trajectories_per_iter": 8, "iterations": iterations,
          "sync_mode": True, "error": out["error"], "resumes": out["resumes"],
          "per_iteration": iters, "rewards": out["rewards"],
          "mean_ratio_tol": AL_MEAN_RATIO_TOL,
          "rollout_tokens_per_s": roll_tok / roll_s if roll_s else None,
          "publishes": out["publishes"], "final_version": out["final_version"],
          "pool_adopted_final": adopted,
          "pool_weights_version": pool_stats.get("weights_version"),
          "buffer": {k: v for k, v in st.items() if k != "consumed_seqs"},
          "rollouts": ro, "launches": counts, "expected_launches": want,
          "build_s": build_s, "run_s": run_s, "max_allocated_gb": peak_gb,
          **({"processes": procs} if procs else {}),
          "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"{tag}: error {out['error']}, "
                             f"ratios {ratios}, buffer {st}, rollouts {ro}, "
                             f"launches {counts} (expected {want}), "
                             f"adopted {adopted}, processes {procs}")
    torch.cuda.empty_cache()
    return counts


# ---------------- off-policy RL, learner groups, the policy server -------


class RecordingAdam:
    """An optimizer that keeps each gradient it is given (a step's
    gradient for adam_card_vs_cpu), then steps the one it wraps."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(grads)
        return self.opt.update(grads, state, params)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def rl_offpolicy_batches():
    """32 DQN minibatches of 64 rows from one seeded ReplayBuffer (obs 4,
    2 actions) and one SAC batch of 128 rows (obs 3, action 1) with its
    noise, all numpy."""
    rng = np.random.RandomState(SEED + 1300)
    buf = replay.ReplayBuffer(4096, 4, seed=SEED + 1301)
    buf.add_batch(rng.randn(4096, 4).astype(np.float32),
                  rng.randint(0, 2, 4096).astype(np.int32),
                  rng.randn(4096).astype(np.float32), rng.rand(4096) < 0.1,
                  rng.randn(4096, 4).astype(np.float32))
    dqn_mbs = [buf.sample(64) for _ in range(32)]
    n = 128
    sac_batch = {"obs": rng.randn(n, 3).astype(np.float32),
                 "actions": np.tanh(rng.randn(n, 1)).astype(np.float32),
                 "rewards": rng.randn(n).astype(np.float32),
                 "next_obs": rng.randn(n, 3).astype(np.float32),
                 "dones": rng.rand(n) < 0.1,
                 "noise_pi": rng.randn(n, 1).astype(np.float32),
                 "noise_next": rng.randn(n, 1).astype(np.float32)}
    return dqn_mbs, sac_batch


def phase_rl_offpolicy_card_vs_cpu(dev="cuda"):
    """DQN's and SAC's updates on the card against the CPU, from the same
    weights (each seeded init drawn on the CPU) and inputs, in f32 with
    TF32 off: 32 double-DQN updates at DQNConfig's defaults (batch 64,
    hidden 64) on minibatches of one seeded ReplayBuffer, and 8
    SACLearner.update steps at its defaults (hidden 128, batch 128) with
    given noise. Each held by adam_card_vs_cpu (every step's gradient,
    the params at rtol 1e-5 above the floor, at most FLOOR_SHARE of a
    leaf below it); the SAC polyak targets at rtol 1e-5, atol 1e-7; the
    last step's metrics at rtol 1e-5, atol 1e-6."""
    dqn_mbs, sac_batch = rl_offpolicy_batches()
    results, ok_all = {}, True
    runs = {}
    for d in (dev, "cpu"):
        algo = dqn.DQNConfig(env_creator=Corridor,
                             num_env_runners=0).build(device=d)
        algo.opt = RecordingAdam(algo.opt)
        for mb in dqn_mbs:
            algo.params, algo.opt_state, loss, td = algo._update_fn(
                algo.params, algo.target_params, algo.opt_state,
                rl_learner.batch_to(mb, dqn._BATCH_KEYS, d))
        runs[d] = (algo, float(loss), float(td))
    lr = dqn.DQNConfig().lr
    ok, ge, pe, fl, fs = adam_card_vs_cpu(
        runs[dev][0].params, runs["cpu"][0].params, runs[dev][0].opt.grads,
        runs["cpu"][0].opt.grads, lr)
    mets = {"loss": (runs[dev][1], runs["cpu"][1]),
            "td_abs": (runs[dev][2], runs["cpu"][2])}
    ok &= all(np.isclose(a, b, rtol=1e-5, atol=1e-6) for a, b in mets.values())
    results["dqn_32_updates"] = dict(ok=ok, grad_err_over_max=ge,
                                     param_max_abs_err=pe, missed_rtol=fl,
                                     below_floor_share=fs, last_metrics=mets)
    ok_all &= ok
    learners, grads, mets = {}, {}, {}
    for d in (dev, "cpu"):
        lrn = sac.SACLearner(3, 1, device=d)
        grads[d] = []
        for _ in range(8):
            m = lrn.update(sac_batch,
                           grad_hook=lambda g, n, out=grads[d]: out.append(g)
                           or g)
        learners[d], mets[d] = lrn, {k: float(v) for k, v in m.items()}
    sac_lr = 3e-4  # SACLearner's default: actor at lr, critics at 3 lr
    ok, ge, pe, fl, fs = adam_card_vs_cpu(
        learners[dev].params, learners["cpu"].params, grads[dev], grads["cpu"],
        lambda path: sac_lr if path.startswith("actor") else 3 * sac_lr)
    target_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(learners[dev].target), tree_leaves(learners["cpu"].target)))
    ok &= all(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-7) for a, b in zip(
        tree_leaves(learners[dev].target), tree_leaves(learners["cpu"].target)))
    m = {k: (mets[dev][k], mets["cpu"][k]) for k in mets["cpu"]}
    ok &= all(np.isclose(a, b, rtol=1e-5, atol=1e-6) for a, b in m.values())
    results["sac_8_updates"] = dict(ok=ok, grad_err_over_max=ge,
                                    param_max_abs_err=pe, missed_rtol=fl,
                                    below_floor_share=fs,
                                    target_max_abs_err=target_err,
                                    last_metrics=m)
    ok_all &= ok
    emit({"phase": "rl_offpolicy_card_vs_cpu",
          "tol": {"rtol": 1e-5, "param_atol": 1e-7, "grad_atol_over_max": 1e-5,
                  "missed_share_max": FLOOR_SHARE, "metrics_atol": 1e-6},
          **results, "card": card(), "ok": bool(ok_all)})
    if not ok_all:
        raise AssertionError(f"rl_offpolicy_card_vs_cpu: {results}")


GROUP_TOL = dict(rtol=1e-4, atol=1e-5)  # JAX's learner-group tests'


def group_batches():
    """tests/test_rl_learner_group.py's 64-row PPO batch (obs 4, 2 actions)
    and a 64-row SAC batch (obs 3, action 1) with its noise."""
    rng = np.random.RandomState(SEED + 1400)
    n = 64
    ppo_batch = {"obs": rng.randn(n, 4).astype(np.float32),
                 "actions": rng.randint(0, 2, n).astype(np.int32),
                 "logp": (-np.abs(rng.randn(n))).astype(np.float32),
                 "advantages": rng.randn(n).astype(np.float32),
                 "returns": rng.randn(n).astype(np.float32)}
    sac_batch = {"obs": rng.randn(n, 3).astype(np.float32),
                 "actions": np.tanh(rng.randn(n, 1)).astype(np.float32),
                 "rewards": rng.randn(n).astype(np.float32),
                 "next_obs": rng.randn(n, 3).astype(np.float32),
                 "dones": rng.rand(n) < 0.1,
                 "noise_pi": rng.randn(n, 1).astype(np.float32),
                 "noise_next": rng.randn(n, 1).astype(np.float32)}
    return ppo_batch, sac_batch


def trees_err(a, b):
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def trees_close(a, b, **tol):
    return all(torch.allclose(x.cpu(), y.cpu(), **tol)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_rl_learner_groups_card(dev="cuda"):
    """The learner groups with both members on the card (threads of the
    in-process runtime, the allreduce a host sum in rank order), each
    against the single learner on the card from the same seed:
    LearnerGroup(2) against Learner on one 64-row batch (minibatches=1,
    epochs=3) and SACLearnerGroup(2) against SACLearner over 3 updates
    with given noise, each at rtol 1e-4, atol 1e-5 (JAX's tolerances),
    the two replicas bit-equal; then PPO with num_learners=2 on the
    corridor for 3 iterations (2 runners of 128 steps, 4 x 4 minibatch
    steps an iteration), its metrics finite and its replicas bit-equal,
    in seconds an iteration."""
    ppo_batch, sac_batch = group_batches()
    results = {}
    solo = rl_learner.Learner(4, 2, device=dev)
    solo.update(dict(ppo_batch), minibatches=1, epochs=3)
    group = learner_group.LearnerGroup(4, 2, num_learners=2, device=dev)
    try:
        t0 = time.perf_counter()
        group.update(dict(ppo_batch), minibatches=1, epochs=3)
        sync(dev)
        group_s = time.perf_counter() - t0
        rt = group.runtime
        a, b = rt.get([rt.call(m, "get_weights") for m in group.learners])
    finally:
        group.shutdown()
    results["learner_group"] = dict(
        ok=trees_close(a, solo.get_weights(), **GROUP_TOL)
        and all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b))),
        max_abs_err=trees_err(a, solo.get_weights()),
        replicas_bit_equal=all(torch.equal(x, y) for x, y in
                               zip(tree_leaves(a), tree_leaves(b))),
        update_s=group_s)
    solo = sac.SACLearner(3, 1, seed=7, device=dev)
    group = learner_group.SACLearnerGroup(3, 1, num_learners=2, seed=7,
                                          device=dev)
    try:
        t0 = time.perf_counter()
        for _ in range(3):
            solo.update(dict(sac_batch))
            group.update(dict(sac_batch))
        sync(dev)
        rt = group.runtime
        a, b = rt.get([rt.call(m, "get_weights") for m in group.learners])
        sac_s = time.perf_counter() - t0
    finally:
        group.shutdown()
    results["sac_learner_group"] = dict(
        ok=trees_close(a, solo.get_weights(), **GROUP_TOL)
        and all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b))),
        max_abs_err=trees_err(a, solo.get_weights()),
        replicas_bit_equal=all(torch.equal(x, y) for x, y in
                               zip(tree_leaves(a), tree_leaves(b))),
        seconds=sac_s)
    algo = ppo.PPOConfig(env_creator=Corridor, obs_dim=2, n_actions=2,
                         num_env_runners=2, lr=5e-3, entropy_coeff=0.0,
                         num_learners=2).build(device=dev)
    seconds, hist = [], []
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            hist.append(algo.train())
            seconds.append(time.perf_counter() - t0)
        rt = algo.runtime
        a, b = rt.get([rt.call(m, "get_weights")
                       for m in algo.learner.learners])
    finally:
        algo.stop()
    results["ppo_two_learners"] = dict(
        ok=(len(hist) == 3 and all(np.isfinite(v) for m in hist
                                   for v in m.values())
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))),
        seconds_per_iteration=seconds,
        episode_return_mean=[m["episode_return_mean"] for m in hist])
    ok = all(r["ok"] for r in results.values())
    emit({"phase": "rl_learner_groups_card", "learners": 2, "device": dev,
          "tol": GROUP_TOL, **results, "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"rl_learner_groups_card: {results}")


def phase_rl_dqn_corridor(dev="cuda"):
    """The port's DQN at JAX's test configuration
    (tests/test_rl_dqn_bc.py:61-71: the corridor, 2 runners of 64 steps,
    learning_starts 128, 64 grad steps an iteration, epsilon over 8
    iterations, the target every 2, lr 2e-3, seed 3), 15 iterations,
    the runners on the CPU and the learner on the card. Pass rule, JAX's:
    the last episode return exceeds max(0.3, the first). Prints seconds
    an iteration and updates a second (the iterations with updates)."""
    algo = dqn.DQNConfig(env_creator=Corridor, obs_dim=2, n_actions=2,
                         num_env_runners=2, rollout_steps=64,
                         learning_starts=128, grad_steps_per_iteration=64,
                         epsilon_decay_iterations=8, target_update_period=2,
                         lr=2e-3, seed=3).build(device=dev)
    fa.reset_launch_count()
    seconds, hist = [], []
    try:
        for _ in range(15):
            t0 = time.perf_counter()
            hist.append(algo.train())
            sync(dev)
            seconds.append(time.perf_counter() - t0)
    finally:
        algo.stop()
    counts = fa.launch_counts()
    curve = [m["episode_return_mean"] for m in hist]
    updates = sum(64 for m in hist if m["buffer_size"] >= 128)
    ok = (curve[-1] > max(0.3, curve[0]) and hist[-1]["buffer_size"] > 128
          and all(np.isfinite(v) for m in hist for v in m.values())
          and sum(counts.values()) == 0)
    emit({"phase": "rl_dqn_corridor", "iterations": 15, "runners": 2,
          "learner_device": dev, "episode_return_mean": curve,
          "pass_rule": "last > max(0.3, first)",
          "seconds_per_iteration": seconds,
          "updates_per_s": updates / sum(seconds),
          "losses": [m["loss"] for m in hist], "launches": counts,
          "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"rl_dqn_corridor: no learning {curve}")
    return counts


def phase_rl_sac_pendulum(dev="cuda"):
    """SAC at SACConfig's defaults on PendulumEnv (1 runner of 256 steps
    an iteration, uniform warm-up for the first 512 steps, 64 grad steps
    of batch 128 an iteration from 512 buffered steps on), 4 iterations
    (the first 2 the warm-up fill), the learner on the card. No learning
    bar (JAX's learning test is slow-marked): metrics finite, grad steps
    in the last 3 iterations. Prints seconds an iteration and grad steps a
    second."""
    algo = sac.SACConfig(env_creator=envs.PendulumEnv).build(device=dev)
    fa.reset_launch_count()
    seconds, hist = [], []
    try:
        for _ in range(4):
            t0 = time.perf_counter()
            hist.append(algo.train())
            sync(dev)
            seconds.append(time.perf_counter() - t0)
    finally:
        algo.stop()
    counts = fa.launch_counts()
    stepped = [i for i, m in enumerate(hist) if "critic_loss" in m]
    ok = (stepped == [1, 2, 3] and hist[-1]["total_steps"] == 1024
          and all(np.isfinite(v) for m in hist for v in m.values())
          and sum(counts.values()) == 0)
    emit({"phase": "rl_sac_pendulum", "iterations": 4, "learner_device": dev,
          "seconds_per_iteration": seconds,
          "grad_steps_per_s": 64 * len(stepped) / sum(seconds[i]
                                                      for i in stepped),
          "metrics": hist, "launches": counts, "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"rl_sac_pendulum: {hist}")
    return counts


class PolicyCorridor(Corridor):
    """tests/test_rl_policy_server.py's corridor: a 40-step limit."""

    def reset(self):
        self.t = 0
        return super().reset()

    def step(self, action):
        self.t += 1
        obs, reward, done, info = super().step(action)
        return obs, reward, done or self.t >= 40, info


def phase_rl_policy_server_card(dev="cuda"):
    """PolicyServer with the policy on the card, deployed through the
    in-process runtime's HTTP ingress, driven by PolicyClient over HTTP:
    (a) a greedy server, where a weight push of a bias to the other action
    flips the served action (JAX's
    test_policy_server_weight_push_changes_actions); (b) an exploring
    server, 16 corridor episodes whose drain_samples arrays have the
    right shapes, logp <= 0 and a done exactly at each episode's end.
    Prints get_action's client-side latency, p50 and p99."""
    mod = rl_module.DiscretePolicyModule(obs_dim=2, n_actions=2)
    params = mod.init(SEED + 1500, device=dev)
    rt = serve_runtime.InProcessRuntime()
    fa.reset_launch_count()
    det = policy_server.PolicyServer(mod, params, name="det", route="/det",
                                     explore=False, runtime=rt, device=dev)
    try:
        client = policy_server.PolicyClient(det.address, route="/det")
        obs = np.array([0.3, 1.0], np.float32)

        def served():
            eid = client.start_episode()
            a = client.get_action(eid, obs)
            client.end_episode(eid)
            return a

        base = served()
        forced = {k: dict(v) for k, v in params.items()}
        forced["pi"]["b"] = torch.zeros(2, device=dev)
        forced["pi"]["b"][1 - base] = 50.0
        det.set_weights(forced)
        flipped = served()
    finally:
        det.shutdown()
    server = policy_server.PolicyServer(mod, params, name="corridor",
                                        route="/corridor", seed=SEED,
                                        runtime=rt, device=dev)
    lat, rets = [], []
    try:
        client = policy_server.PolicyClient(server.address, route="/corridor")
        env = PolicyCorridor()
        t0 = time.perf_counter()
        for _ in range(16):
            eid, obs, total = client.start_episode(), env.reset(), 0.0
            while True:
                t1 = time.perf_counter()
                a = client.get_action(eid, obs)
                lat.append(time.perf_counter() - t1)
                obs, r, done, _ = env.step(a)
                client.log_returns(eid, r)
                total += r
                if done:
                    client.end_episode(eid, obs)
                    break
            rets.append(total)
        episodes_s = time.perf_counter() - t0
        batch = server.drain_samples()
    finally:
        server.shutdown()
    counts = fa.launch_counts()
    n = len(batch["actions"])
    shapes_ok = (batch["obs"].shape == (n, 2) and batch["logp"].shape == (n,)
                 and batch["rewards"].shape == (n,) and n == len(lat)
                 and batch["actions"].dtype == np.int32
                 and bool(np.all(batch["logp"] <= 0))
                 and int(batch["dones"].sum()) == 16 and bool(batch["dones"][-1])
                 and np.allclose(batch["episode_returns"], rets))
    ok = flipped == 1 - base and shapes_ok and sum(counts.values()) == 0
    emit({"phase": "rl_policy_server_card", "policy_device": dev,
          "ingress": "in-process stdlib HTTP", "weight_push_flips": flipped == 1 - base,
          "episodes": 16, "transitions": n, "drain_shapes_ok": shapes_ok,
          "get_action_ms": percentiles(lat, 1e3), "episodes_s": episodes_s,
          "launches": counts, "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"rl_policy_server_card: flipped {flipped} from "
                             f"{base}, shapes {shapes_ok}, launches {counts}")
    return counts


def post_json(address, route, body, timeout=600):
    """One POST of a JSON body; (status, decoded reply)."""
    import http.client

    conn = http.client.HTTPConnection(*address, timeout=timeout)
    try:
        conn.request("POST", route, json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"null")
    finally:
        conn.close()


HTTP_REQUESTS, HTTP_NEW_TOKENS = 4, 32


def serve_over_http(address, route, prompts, new_tokens):
    """Each prompt POSTed as {"prompt_ids", "max_tokens"} from a thread of
    its own, all at once; returns (replies, wall seconds)."""
    replies = [None] * len(prompts)

    def one(i):
        replies[i] = post_json(address, route, {
            "prompt_ids": prompts[i].tolist(), "max_tokens": new_tokens})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return replies, time.perf_counter() - t0


def phase_serving_1b_http(cfg, params, greedy_tokens):
    """run_llm_pool at Llama-1B (one replica of serving_1b_pool's shape,
    weights from the same seed) through the in-process runtime's deploy,
    4 greedy requests of 32 new tokens POSTed at once to its HTTP
    ingress. Checks: every reply 200, each request's tokens agree with
    serving_1b's greedy stream for its prompt (its first 32 tokens; the
    near-tie rule), no flash launch, and the pool's pump threads end at
    shutdown. Prints the deploy (spawn) seconds and the HTTP tokens/s."""
    _, prompts = serving_requests()
    prompts = prompts[:HTTP_REQUESTS]
    rt = PoolRuntime()
    fa.reset_launch_count()
    t0 = time.perf_counter()
    handle = llm_pool.run_llm_pool(
        "llm_http", runtime=rt, model_size="1b", min_replicas=1,
        max_replicas=1, autoscale=False, slots=8, max_len=288,
        chunk_tokens=32, prompt_buckets=(128,), seed=SEED, device="cuda")
    spawn_s = time.perf_counter() - t0
    try:
        address = rt.http_address()
        replies, dt = serve_over_http(address, "/llm_http", prompts,
                                      HTTP_NEW_TOKENS)
    finally:
        rt.get(rt.call(handle, "shutdown"), timeout=120)
        rt.kill(handle)
    counts = fa.launch_counts()
    statuses = [s for s, _ in replies]
    diverged = []
    for p, (_, body), want in zip(prompts, replies, greedy_tokens):
        got = body["tokens"]
        diverged.append(assert_tokens_agree(
            got, list(want[:HTTP_NEW_TOKENS]),
            stream_scores(params, cfg, p, got))[0])
    pumps_ended = all(not th.is_alive() for th in rt.pumps)
    ok = (statuses == [200] * HTTP_REQUESTS and pumps_ended
          and sum(counts.values()) == 0
          and all(len(b["tokens"]) == HTTP_NEW_TOKENS for _, b in replies))
    emit({"phase": "serving_1b_http", "requests": HTTP_REQUESTS,
          "new_tokens": HTTP_NEW_TOKENS, "replicas": 1,
          "ingress": "in-process stdlib HTTP", "spawn_s": spawn_s,
          "replica_spawn_s": [s for _, s in rt.spawns], "seconds": dt,
          "http_tokens_per_sec": HTTP_REQUESTS * HTTP_NEW_TOKENS / dt,
          "statuses": statuses,
          "equal_to_serving_1b": sum(d is None for d in diverged),
          "first_divergence": diverged, "pumps_ended": pumps_ended,
          "launches": counts, "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"serving_1b_http: statuses {statuses}, pumps "
                             f"ended {pumps_ended}, launches {counts}")
    return counts


def ship_and_fetch(src, dest_root):
    """ship_checkpoint of ``src`` through an in-process runtime, then
    fetch_checkpoint into ``dest_root`` (which verifies every crc32);
    each member of the fetched copy compared with the source byte for
    byte, 64 MiB at a time. Returns the timings, bytes and the result."""
    rt = serve_runtime.InProcessRuntime()
    t0 = time.perf_counter()
    ref = ckpt_mod.ship_checkpoint(src, runtime=rt)
    ship_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    got = ckpt_mod.fetch_checkpoint(ref, dest_root, runtime=rt)
    fetch_s = time.perf_counter() - t1
    n_bytes = sum(a.nbytes for a in ref["members"].values())
    del ref
    t2 = time.perf_counter()
    equal = sorted(os.listdir(src)) == sorted(os.listdir(got.path))
    for fn in sorted(os.listdir(src)):
        with open(os.path.join(src, fn), "rb") as a, \
                open(os.path.join(got.path, fn), "rb") as b:
            while equal:
                x, y = a.read(64 * 2**20), b.read(64 * 2**20)
                equal = x == y
                if not x:
                    break
    return {"ship_s": ship_s, "fetch_s": fetch_s,
            "compare_s": time.perf_counter() - t2, "bytes": n_bytes,
            "members": len(os.listdir(src)), "byte_equal": bool(equal),
            "verified": True}


# JAX's committed floors on these families (tests/test_runtime_perf.py):
# printed beside each figure as met or not, never asserted (host-paced)
RP_FLOORS = {
    "transfer": lambda r: [
        ("publish latency_s <= 2.0", r[0]["latency_s"], r[0]["latency_s"] <= 2.0),
        ("kv handoff latency_s <= 2.0", r[1]["latency_s"],
         r[1]["latency_s"] <= 2.0)],
    "serve": lambda r: [
        ("2 replicas >= 1.6 x 1 replica", r[1]["per_s"] / r[0]["per_s"],
         r[1]["per_s"] >= 1.6 * r[0]["per_s"])] + [
        (f"{x['name']}: ttft_p99_s < 10", x["ttft_p99_s"], x["ttft_p99_s"] < 10.0)
        for x in r],
    "serve_spec": lambda r: [
        ("depth 4 sampled >= 1.5 x off", r[5]["per_s"] / r[3]["per_s"],
         r[5]["per_s"] >= 1.5 * r[3]["per_s"]),
        ("depth 2 sampled >= 1.2 x off", r[4]["per_s"] / r[3]["per_s"],
         r[4]["per_s"] >= 1.2 * r[3]["per_s"])],
    "rl": lambda r: [
        ("rollout >= 40 tokens/s", r[0]["per_s"], r[0]["per_s"] >= 40),
        ("experience >= 40 ops/s", r[1]["per_s"], r[1]["per_s"] >= 40),
        ("experience >= 1.0 MB/s", r[1]["mb_per_s"], r[1]["mb_per_s"] >= 1.0),
        ("publish latency_s <= 2.0", r[2]["latency_s"], r[2]["latency_s"] <= 2.0)],
    "pipeline": lambda r: [
        ("steps/s >= 0.5", r[0]["per_s"], r[0]["per_s"] >= 0.5),
        ("bubble_measured <= 0.75", r[0]["bubble_measured"],
         r[0]["bubble_measured"] <= 0.75),
        ("hops/s >= 8", r[1]["per_s"], r[1]["per_s"] >= 8)],
}


def runtime_perf_contract(family, r) -> list[str]:
    """What is wrong with a family's records by the correctness contract
    of JAX's committed floors; empty when nothing is."""
    bad = []
    if family == "transfer":
        if r[0]["weight_bytes"] != 427264 or r[1]["latency_s"] <= 0:
            bad.append("publish or KV handoff")
    elif family == "serve":
        if not (r[2]["prefix_hit_rate"] or 0) >= 0.5:
            bad.append(f"prefix hit rate {r[2]['prefix_hit_rate']}")
    elif family == "serve_spec":
        for x in r:
            if x["spec_depth"] and not (x["match_baseline"] is True
                                        and x["acceptance_rate"] is not None):
                bad.append(f"{x['name']}: {x['match_baseline']}, "
                           f"{x['acceptance_rate']}")
    elif family == "rl":
        if r[1]["traj_bytes"] != 51200 or r[2]["weight_bytes"] != 427264:
            bad.append("experience or publish bytes")
    elif family == "pipeline":
        p = r[0]
        if not (p["heals"] == 0 and p["gang_restarts"] == 0
                and abs(p["bubble_analytic"] - 1 / 9) < 1e-3
                and p["bubble_analytic"] <= p["bubble_measured"] <= 0.75):
            bad.append(f"pipeline {p}")
    return bad


def phase_runtime_perf(family):
    """One family of the port's runtime_perf (the JAX module's families
    that run model code) with quick=True on the card, over the in-process
    runtimes: the tiny model behind an emulated 0.05 s chunk dispatch, or
    the 256x256 numpy pipeline. Records on the phase line; the
    correctness contract of JAX's floors is asserted (the family itself
    raises on a failed request, a short stream or a changed trajectory),
    JAX's speed floors printed beside the figures as met or not."""
    fa.reset_launch_count()
    with contextlib.redirect_stdout(io.StringIO()):  # records go on our line
        records = runtime_perf.RUNNERS[family](quick=True, device="cuda")
    counts = fa.launch_counts()
    bad = runtime_perf_contract(family, records)
    floors = [{"floor": f, "value": v, "met": bool(m)}
              for f, v, m in RP_FLOORS[family](records)]
    ok = not bad and sum(counts.values()) == 0
    emit({"phase": f"runtime_perf_{family}", "quick": True, "device": "cuda",
          "records": records, "jax_floors": floors, "launches": counts,
          "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"runtime_perf_{family}: {bad}, launches {counts}")
    return counts


def phase_runtime_perf_serve_procs():
    """runtime_perf's serve family (quick) as phase_runtime_perf runs it,
    with each pool member in a process of its own (a ProcessRuntime):
    pool decode at 1 and 2 replicas and with the prefix cache. The
    serve family's contract is asserted, and every member process has
    exited after the runtime's shutdown. The 1 -> 2 replica ratio is
    printed beside runtime_perf_serve's (in-process) and beside JAX's 1.6
    floor, as met or not."""
    rt = TimedProcessRuntime()
    try:
        fa.reset_launch_count()
        with contextlib.redirect_stdout(io.StringIO()):
            records = runtime_perf.run_serve_benchmarks(
                quick=True, device="cuda", runtime=rt)
        counts = fa.launch_counts()
    finally:
        rt.shutdown()
    bad = runtime_perf_contract("serve", records)
    ratio = records[1]["per_s"] / records[0]["per_s"]
    inproc = RECORDS.get("runtime_perf_serve", {}).get("records")
    members = rt._members
    exited = processes_gone(members)
    ok = (not bad and sum(counts.values()) == 0 and exited
          and len(members) == 5)
    emit({"phase": "runtime_perf_serve_procs", "quick": True,
          "device": "cuda", "runtime": "ProcessRuntime", "records": records,
          "replicas_2_over_1": ratio,
          "replicas_2_over_1_in_process": (
              inproc[1]["per_s"] / inproc[0]["per_s"] if inproc else None),
          "jax_floor_2_over_1": {"floor": 1.6, "met": ratio >= 1.6},
          "jax_floors": [{"floor": f, "value": v, "met": bool(m)}
                         for f, v, m in RP_FLOORS["serve"](records)],
          "spawn_split": spawn_split(rt),
          "member_pids": [m.pid for m in members],
          "exited_after_shutdown": exited, "launches": counts,
          "card": card(), "ok": ok})
    if not ok:
        raise AssertionError(f"runtime_perf_serve_procs: {bad}, launches "
                             f"{counts}, exited {exited}, members "
                             f"{len(members)}")
    return counts


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


def time_kernel(entry, shape, peaks, seed, plain_iters=5):
    """C entry point `entry` at `shape` (B, Hq, Hkv, T, S, D; bf16, causal),
    through its wrapper, in turns plain, kernel, kernel, plain, library;
    with its error against the plain version there, held to TOL / BWD_TOL,
    and its bound."""
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
    kern_a, kern_b = time_ms(run), time_ms(run)
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
# main-path shapes (B, Hq, Hkv, T, S, D): the forward's 1B scoring shape
# (and its 350m training shape), the fused backward's 350m training
# shape, and the dq/dkv kernels' at 350m width with T = S = 16384
MAIN_SHAPES = {
    "flash_fwd_sm90": (2, 16, 8, 2048, 2048, 128),
    "flash_bwd_fused_sm90": (8, 8, 8, 2048, 2048, 128),
    "flash_bwd_dq_sm90": (1, 8, 8, 16384, 16384, 128),
    "flash_bwd_dkv_sm90": (1, 8, 8, 16384, 16384, 128),
}


# the RL learner's shape (actor_learner_1b: 8 trajectories of 64 + 64
# tokens at Llama-1B), timed beside each main shape of its two kernels
RL_SHAPES = {"flash_fwd_sm90": (8, 16, 8, 128, 128, 128),
             "flash_bwd_fused_sm90": (8, 16, 8, 128, 128, 128)}
# what a kernels-line entry keeps of a timing at a further shape
SHAPE_KEYS = ("shape", "kernel_ms", "kernel_graph_ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "library_graph_ms", "library_fwd_bwd_ms",
              "library_fwd_ms", "share_of_bound", "max_abs_err")


def phase_kernels_line(launches, peaks, build_info):
    """One entry per main-path kernel: its launches on the main paths, its
    time, error, bound, plain and library times, share of bound, and
    ptxas's registers and shared memory."""
    kernels = []
    for i, (kernel, shape) in enumerate(MAIN_SHAPES.items()):
        row = time_kernel(kernel, shape, peaks, SEED + 400 + i,
                          plain_iters=2 if shape[3] > 4096 else 5)
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
        if kernel == "flash_fwd_sm90":
            train_row = time_kernel(kernel, MAIN_SHAPES["flash_bwd_fused_sm90"],
                                    peaks, SEED + 410)
            entry["train_350m"] = {k: train_row[k] for k in SHAPE_KEYS
                                   if k in train_row}
        if kernel in RL_SHAPES:
            rl_row = time_kernel(kernel, RL_SHAPES[kernel], peaks, SEED + 420 + i)
            entry["rl_1b"] = {k: rl_row[k] for k in SHAPE_KEYS if k in rl_row}
        kernels.append(entry)
    return kernels


def expected(**launches):
    """Launches per step by entry point: those named, 0 for the rest."""
    return {**{k: 0 for k in fa.launch_counts()}, **launches}


# --phases takes these groups, or any phase of one (which runs its group)
GROUPS = {
    "kernels": ("kernel_vs_plain", "bwd_kernel_vs_plain", "bwd_determinism",
                "bwd_routes"),
    "serving": ("init_1b", "scoring_1b", "serving_1b", "prng_card_vs_cpu",
                "serving_1b_sampled", "serving_1b_spec", "serving_1b_prefix",
                "serving_1b_disaggregated", "serving_1b_server",
                "serving_1b_pool", "serving_1b_pool_procs", "serving_1b_http",
                "exactness_f32_2layer"),
    "moe": ("init_1b_moe", "scoring_1b_moe", "serving_1b_moe",
            "moe_layer_card_vs_cpu", "exactness_f32_2layer_moe",
            "serving_moe_tiny_server", "train_1b_moe"),
    "train": ("train_350m", "train_1b", "train_long_context",
              "grad_exactness_f32", "sr_card_vs_cpu"),
    "mesh": ("mesh_dryrun_card", "train_1b_mesh", "seq_parallel_card"),
    "pipeline": ("pipeline_gpipe_card", "pipeline_mpmd_1b"),
    "trainer": ("train_1b_trainer",),
    "rl": ("rl_card_vs_cpu", "rl_ppo_corridor", "actor_learner_1b",
           "actor_learner_1b_procs"),
    "rl_offpolicy": ("rl_offpolicy_card_vs_cpu", "rl_learner_groups_card",
                     "rl_dqn_corridor", "rl_sac_pendulum",
                     "rl_policy_server_card"),
    "runtime_perf": tuple(f"runtime_perf_{f}" for f in runtime_perf.RUNNERS)
    + ("runtime_perf_serve_procs",),
    "profile": ("profile_train_350m", "profile_train_long_context"),
}


def selected_groups(argv) -> set:
    """The groups ``--phases a,b,...`` names (every group without it)."""
    if "--phases" not in argv:
        return set(GROUPS)
    names = argv[argv.index("--phases") + 1].split(",")
    out = set()
    for name in names:
        hit = [g for g, phases in GROUPS.items() if name == g or name in phases]
        if not hit:
            raise SystemExit(f"unknown phase {name!r}; groups: {sorted(GROUPS)}")
        out.update(hit)
    return out


def main() -> None:
    groups = selected_groups(sys.argv[1:])
    t_start = time.perf_counter()
    name, smi, peaks = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 checks are full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    build_info = phase_build()
    if "kernels" in groups:
        phase_kernel_vs_plain()
        phase_bwd_kernel_vs_plain()
        phase_bwd_determinism()
        phase_bwd_routes()
    # each main path: counts set to 0 just before it, read just after
    by_path = {}
    if "serving" in groups:
        cfg = bench_1b_config()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama.init_params(cfg, g, device="cuda")
        emit({"phase": "init_1b", "n_params": cfg.num_params(),
              "layers": cfg.n_layers, "d_model": cfg.d_model})
        with torch.inference_mode():
            by_path["scoring_1b"] = phase_scoring(cfg, params)
            by_path["serving_1b"], greedy_tokens = phase_serving(cfg, params)
            phase_prng_card_vs_cpu()
            by_path["serving_1b_sampled"], sampled_tokens = phase_serving_sampled(
                cfg, params)
            by_path["serving_1b_spec"] = phase_serving_spec(cfg, params, {
                "greedy": (RECORDS["serving_1b"]["engine_tokens_per_sec"],
                           greedy_tokens),
                "sampled": (RECORDS["serving_1b_sampled"]["engine_tokens_per_sec"],
                            sampled_tokens)})
            by_path["serving_1b_prefix"] = phase_serving_prefix(cfg, params)
            by_path["serving_1b_disaggregated"] = phase_serving_disaggregated(
                cfg, params, sampled_tokens)
            by_path["serving_1b_server"] = phase_serving_server(greedy_tokens)
            by_path["serving_1b_pool"] = phase_serving_pool(
                cfg, params, greedy_tokens, sampled_tokens)
            by_path["serving_1b_pool_procs"] = phase_serving_pool_procs(
                cfg, params, greedy_tokens, sampled_tokens)
            by_path["serving_1b_http"] = phase_serving_1b_http(
                cfg, params, greedy_tokens)
            del params
            torch.cuda.empty_cache()
            phase_exactness_f32()
    if "moe" in groups:
        with torch.inference_mode():
            moe_cfg, moe_params = phase_init_1b_moe()
            by_path["scoring_1b_moe"] = phase_scoring_1b_moe(moe_cfg, moe_params,
                                                             peaks)
            by_path["serving_1b_moe"] = phase_serving_1b_moe(moe_cfg, moe_params)
            del moe_params
            torch.cuda.empty_cache()
            phase_moe_layer_card_vs_cpu(moe_cfg)
            phase_exactness_f32_2layer_moe()
            by_path["serving_moe_tiny_server"] = phase_serving_moe_tiny_server()
        by_path["train_1b_moe"] = phase_train(
            "train_1b_moe", train_config("1b", "flash_qkv", n_experts=8, top_k=2,
                                         n_layers=8), 2, 2048,
            expected(flash_fwd_sm90=8, flash_bwd_fused_sm90=8), peaks)
    n350 = llama.llama2_size("350m").n_layers
    n1b = llama.llama2_size("1b").n_layers
    long_cfg = train_config("350m", "dots_flash_qkv_mlp", n_layers=2,
                            max_seq_len=16384)
    if "train" in groups:
        by_path["train_350m"] = phase_train(
            "train_350m", train_config("350m", "dots_flash_qkv_mlp"), 8, 2048,
            expected(flash_fwd_sm90=n350, flash_bwd_fused_sm90=n350), peaks)
        by_path["train_1b"] = phase_train(
            "train_1b", train_config("1b", "flash_qkv"), 2, 2048,
            expected(flash_fwd_sm90=n1b, flash_bwd_fused_sm90=n1b), peaks)
        by_path["train_long_context"] = phase_train(
            "train_long_context", long_cfg, 1, 16384,
            expected(flash_fwd_sm90=2, flash_bwd_dq_sm90=2, flash_bwd_dkv_sm90=2),
            peaks)
        phase_grad_exactness_f32()
        phase_sr_card_vs_cpu()
    if "mesh" in groups:
        phase_mesh_dryrun_card()
        by_path["train_1b_mesh"] = phase_train_1b_mesh(
            expected(flash_fwd_sm90=n1b, flash_bwd_fused_sm90=n1b))
        by_path["seq_parallel_card"] = phase_seq_parallel_card()
    if "pipeline" in groups:
        by_path["pipeline_gpipe_card"] = phase_pipeline_gpipe_card()
        by_path["pipeline_mpmd_1b"] = phase_pipeline_mpmd_1b()
    if "trainer" in groups:
        by_path["train_1b_trainer"] = phase_train_1b_trainer()
    if "rl" in groups:
        phase_rl_card_vs_cpu()
        phase_rl_ppo_corridor()
        by_path["actor_learner_1b"] = phase_actor_learner_1b()
        procs = TimedProcessRuntime()
        try:
            by_path["actor_learner_1b_procs"] = phase_actor_learner_1b(
                procs, iterations=1, tag="actor_learner_1b_procs")
        finally:
            procs.shutdown()
    if "rl_offpolicy" in groups:
        phase_rl_offpolicy_card_vs_cpu()
        phase_rl_learner_groups_card()
        by_path["rl_dqn_corridor"] = phase_rl_dqn_corridor()
        by_path["rl_sac_pendulum"] = phase_rl_sac_pendulum()
        by_path["rl_policy_server_card"] = phase_rl_policy_server_card()
    if "runtime_perf" in groups:
        for family in runtime_perf.RUNNERS:
            by_path[f"runtime_perf_{family}"] = phase_runtime_perf(family)
        by_path["runtime_perf_serve_procs"] = phase_runtime_perf_serve_procs()
    if "profile" in groups:
        phase_profile("profile_train_350m",
                      train_config("350m", "dots_flash_qkv_mlp"), 8, 2048)
        phase_profile("profile_train_long_context", long_cfg, 1, 16384, steps=5)
    emit({"phase": "launches_by_path", **by_path})
    if groups == set(GROUPS):
        launches = {}
        for counts in by_path.values():
            add_counts(launches, counts)
        for kernel in SOURCES:
            if launches.get(kernel, 0) == 0:
                raise AssertionError(f"{kernel} was launched no time on the main "
                                     f"paths: {by_path}")
        kernels = phase_kernels_line(launches, peaks, build_info)
    emit({"phase": "memory",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
          "script_seconds": time.perf_counter() - t_start,
          "groups": sorted(groups)})
    print(smi.splitlines()[0], flush=True)
    if groups == set(GROUPS):
        emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
