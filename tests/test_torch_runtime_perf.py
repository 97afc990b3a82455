"""The port's runtime_perf families on the CPU, against the JAX module's.

``ray_tpu_torch._private.runtime_perf`` keeps the families of
ray_tpu/_private/runtime_perf.py that run model code. Each family runs
once here (``device="cpu"``, ``quick=True``, the in-process runtimes) and
is held to the records the JAX module committed in ``RUNTIME_BENCH.json``:

- the family's record names, letter for letter;
- each record's key set;
- the values ``quick`` does not change (replicas, concurrency,
  new_tokens, chunk_delay_s, chunk_tokens, spec_depth, temperature,
  traj_bytes, weight_bytes, microbatches, bubble_analytic);
- the correctness contract of JAX's committed floors
  (tests/test_runtime_perf.py): the prefix configuration hits at >= 0.5,
  publish and KV handoff complete with weight_bytes > 0, the pipeline
  has no heal and no gang restart, bubble_analytic 1/9, and a measured
  bubble in (0, 0.75], JAX's upper bound. JAX's lower bound on the
  measured bubble (the
  analytic 1/9) is a timing property: the analytic bubble assumes equal
  stage times, JAX's lanes add transport time to every wait, and the
  in-process lanes add none. A run of this suite beside five other
  workers measured 0.1039, so the bound is held on the card, by
  ``chip_smoke.py``'s ``runtime_perf_pipeline``, not here.

No speed floor is asserted: the figures are host-paced and these tests
run beside others. ``run_benchmarks`` runs the families JAX's
``run_benchmarks`` runs that are here, in JAX's order, and so emits
JAX's records: the pipeline family is not among them. The speculative family is in
``test_torch_runtime_perf_spec.py``. Also here: the pipeline family's
stages, run with ``return_params``, give losses and params bit-equal to
the sequential numpy baseline (JAX's tests/test_mpmd_pipeline.py
``baseline``, over the family's stages), and ``main`` writes
``{"results", "ts"}`` as JAX's does.
"""

import ast
import json
import pathlib

import numpy as np
import pytest

from ray_tpu_torch._private import runtime_perf
from ray_tpu_torch.parallel.pipeline_runtime import InProcessPipelineRuntime
from ray_tpu_torch.serve.runtime import InProcessRuntime

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the keys whose values quick leaves as they are
FIXED = ("replicas", "concurrency", "new_tokens", "chunk_delay_s",
         "chunk_tokens", "spec_depth", "temperature", "traj_bytes",
         "weight_bytes", "microbatches", "bubble_analytic")
PREFIXES = {
    "transfer": ("transfer weight publish", "transfer kv handoff"),
    "serve": ("serve pool decode",),
    "serve_spec": ("serve spec decode",),
    "rl": ("rl ",),
    "pipeline": ("pipeline ",),
}


def jax_records(family: str) -> list[dict]:
    """The JAX module's committed records of ``family``, in order."""
    rec = json.loads((ROOT / "RUNTIME_BENCH.json").read_text())["results"]
    return [r for r in rec if r["name"].startswith(PREFIXES[family])]


def assert_like_jax(family: str, got: list[dict]) -> None:
    want = jax_records(family)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["name"]
        for key in FIXED:
            if key in w:
                assert g[key] == w[key], (g["name"], key)


class CountingRuntime(InProcessRuntime):
    """The in-process runtime, counting the members spawned through it."""

    def __init__(self):
        super().__init__()
        self.spawned = []

    def spawn(self, cls, kwargs, **kw):
        self.spawned.append(cls.__name__)
        return super().spawn(cls, kwargs, **kw)


@pytest.fixture(scope="module")
def transfer():
    rt = CountingRuntime()
    return rt, runtime_perf.run_transfer_benchmarks(quick=True, device="cpu",
                                                    runtime=rt)


@pytest.fixture(scope="module")
def serve():
    return runtime_perf.run_serve_benchmarks(quick=True, device="cpu")


@pytest.fixture(scope="module")
def rl():
    rt = CountingRuntime()
    return rt, runtime_perf.run_rl_benchmarks(quick=True, device="cpu",
                                              runtime=rt)


class Spans:
    def __init__(self):
        self.spans = []

    def record(self, cat, name, t0, t1, attrs=None):
        self.spans.append(name)


@pytest.fixture(scope="module")
def pipeline():
    rec = Spans()
    return rec, runtime_perf.run_pipeline_benchmarks(
        quick=True, device="cpu", runtime=InProcessPipelineRuntime(rec))


def test_transfer_consumer_tier_like_jax(transfer):
    rt, got = transfer
    assert_like_jax("transfer", got)
    pub, kv = got
    assert pub["weight_bytes"] == 427264 and pub["latency_s"] > 0
    assert kv["latency_s"] > 0 and kv["per_s"] > 0
    # two decode replicas and one prefill worker, through the runtime given
    assert sorted(rt.spawned) == ["LLMServer", "LLMServer", "PrefillWorker"]


def test_serve_family_like_jax(serve):
    assert_like_jax("serve", serve)
    for r in serve:
        assert r["n_requests"] == 16  # quick halves the requests
        assert 0 < r["ttft_p50_s"] <= r["ttft_p99_s"] and r["per_s"] > 0
    assert serve[0]["prefix_hit_rate"] is None
    assert serve[1]["prefix_hit_rate"] is None


def test_serve_prefix_configuration_hits(serve):
    assert serve[2]["prefix_hit_rate"] >= 0.5


def test_rl_family_like_jax(rl):
    rt, got = rl
    assert_like_jax("rl", got)
    roll, xfer, pub = got
    assert roll["n_requests"] == 12 and roll["per_s"] > 0
    assert xfer["traj_bytes"] == 51200 and xfer["mb_per_s"] > 0
    assert pub["weight_bytes"] == 427264 and pub["latency_s"] > 0
    assert sorted(rt.spawned) == ["ExperienceBuffer", "LLMServer",
                                  "LLMServer"]


def test_pipeline_family_like_jax(pipeline):
    rec, got = pipeline
    assert_like_jax("pipeline", got)
    steps, hops = got
    assert steps["steps"] == 4 and hops["per_s"] > 0
    assert steps["heals"] == 0 and steps["gang_restarts"] == 0
    assert abs(steps["bubble_analytic"] - 1 / 9) < 1e-3
    assert 0 < steps["bubble_measured"] <= 0.75
    # the runtime given took the workers' spans: 2 stages x 4 steps
    assert rec.spans.count("pipeline.step") == 8


def pipeline_baseline(steps, mbs, lr=0.05):
    """tests/test_mpmd_pipeline.py's sequential baseline over the family's
    stages: the same math, no pipeline. A step's loss is the running sum
    of its microbatches' losses, the last stage's own order: Python's
    ``sum`` of floats is compensated since 3.12, and at these magnitudes
    it differs from the running sum in the last bit."""
    f = runtime_perf
    p0, p1 = f._pipe_init({}), f._pipe_init({})
    losses = []
    for step in range(steps):
        g0 = np.zeros_like(p0["w"])
        g1 = np.zeros_like(p1["w"])
        loss_sum = 0.0
        for m in range(mbs):
            x, t = f._pipe_data(step, m)
            y0, s0 = f._pipe_fwd(p0, x)
            y1, s1 = f._pipe_fwd(p1, y0)
            loss, dy = f._pipe_loss(p1, y1, t)
            loss_sum += loss
            dx1, gg1 = f._pipe_bwd(p1, s1, dy)
            _, gg0 = f._pipe_bwd(p0, s0, dx1)
            g0 += gg0["w"]
            g1 += gg1["w"]
        p0["w"] = p0["w"] - lr * g0 / mbs
        p1["w"] = p1["w"] - lr * g1 / mbs
        losses.append(loss_sum / mbs)
    return losses, p0, p1


def test_pipeline_family_stages_are_bit_equal_to_the_baseline():
    res = runtime_perf._pipeline(3, return_params=True).fit()
    bl, p0, p1 = pipeline_baseline(3, runtime_perf.PIPE_MICROBATCHES)
    assert res.steps_completed == 3 and res.heals == 0
    np.testing.assert_array_equal(res.losses, bl)
    np.testing.assert_array_equal(res.final_params[0]["w"], p0["w"])
    np.testing.assert_array_equal(res.final_params[1]["w"], p1["w"])


def test_main_writes_results_like_jax(tmp_path):
    out = tmp_path / "bench.json"
    results = runtime_perf.main(["--family", "pipeline", "--quick",
                                 "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert set(doc) == {"results", "ts"}
    assert doc["results"] == results
    assert_like_jax("pipeline", results)


def test_main_takes_jax_families():
    with pytest.raises(SystemExit):
        runtime_perf.main(["--family", "qos", "--device", "cpu"])
    assert set(runtime_perf.RUNNERS) == set(PREFIXES)


def jax_run_benchmarks_families() -> list[str]:
    """The families JAX's ``run_benchmarks`` calls, in its order, by the
    ``run_<family>_benchmarks`` calls in its source."""
    src = (ROOT / "ray_tpu" / "_private" / "runtime_perf.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "run_benchmarks")
    calls = sorted((n.lineno, n.func.id) for n in ast.walk(fn)
                   if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                   and n.func.id.startswith("run_"))
    return [name[len("run_"):-len("_benchmarks")] for _, name in calls]


def test_run_benchmarks_emits_jax_records(monkeypatch):
    """Each family stubbed by JAX's committed records of it: what
    ``run_benchmarks`` returns is JAX's records of the families JAX's
    ``run_benchmarks`` runs, in its order, among those the port has."""
    ran = []
    for fam in runtime_perf.RUNNERS:
        def stub(*, quick, device, runtime, fam=fam):
            ran.append(fam)
            return jax_records(fam)
        monkeypatch.setitem(runtime_perf.RUNNERS, fam, stub)
    jax_order = [f for f in jax_run_benchmarks_families()
                 if f in runtime_perf.RUNNERS]
    got = runtime_perf.run_benchmarks(quick=True, device="cpu")
    assert ran == jax_order == ["serve", "serve_spec", "rl", "transfer"]
    assert [r["name"] for r in got] == [
        r["name"] for f in jax_order for r in jax_records(f)]
    assert not any(r["name"].startswith("pipeline") for r in got)
    assert "pipeline" in runtime_perf.RUNNERS  # --family pipeline
