"""The port stands alone: no JAX, nothing of ray_tpu, no silent CPU runs."""

import ast
import pathlib

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.models import decode_engine, llama, mlp
from ray_tpu_torch.serve import llm, llm_pool

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")
# the port's RL layer: ray_tpu/rl/'s modules that are ported
RL_MODULES = ("__init__", "vtrace", "models", "rl_module", "learner", "bc",
              "envs", "connectors", "multi_agent", "env_runner",
              "vector_env", "ppo", "impala", "appo", "experience",
              "actor_learner", "replay", "dqn", "sac", "learner_group",
              "policy_server")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
              # spawned ranks import it by name: it must import neither
              ROOT / "tests" / "test_torch_dist_ranks.py",
              # so do the process runtime's test members
              ROOT / "tests" / "process_members.py"]
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"chip_smoke.py", "chip_ab.py",
            "ray_tpu_torch/ops/flash_attention.py",
            "ray_tpu_torch/models/decode_engine.py",
            "ray_tpu_torch/models/llama.py", "ray_tpu_torch/models/mlp.py",
            "ray_tpu_torch/serve/hooks.py", "ray_tpu_torch/serve/llm.py",
            "ray_tpu_torch/serve/llm_pool.py",
            "ray_tpu_torch/serve/runtime.py",
            "ray_tpu_torch/serve/process_runtime.py",
            "ray_tpu_torch/serve/overload.py",
            "ray_tpu_torch/serve/multiplex.py",
            "ray_tpu_torch/autoscaler/demand_scheduler.py",
            "ray_tpu_torch/train/optim.py",
            "ray_tpu_torch/train/step.py",
            "ray_tpu_torch/parallel/mesh.py",
            "ray_tpu_torch/parallel/sharding.py",
            "ray_tpu_torch/parallel/launch.py",
            "ray_tpu_torch/collective/mesh_ops.py",
            "ray_tpu_torch/collective/compression.py",
            "ray_tpu_torch/collective/ring.py",
            "ray_tpu_torch/collective/collective.py",
            "ray_tpu_torch/ops/ring_attention.py",
            "ray_tpu_torch/ops/ulysses.py",
            "ray_tpu_torch/multichip.py",
            "ray_tpu_torch/parallel/pipeline.py",
            "ray_tpu_torch/parallel/mpmd_pipeline.py",
            "ray_tpu_torch/parallel/pipeline_runtime.py",
            "ray_tpu_torch/train/checkpoint.py",
            "ray_tpu_torch/train/session.py",
            "ray_tpu_torch/train/dcn.py",
            "ray_tpu_torch/train/fault_injection.py",
            "ray_tpu_torch/train/worker_group.py",
            "ray_tpu_torch/train/backend_executor.py",
            "ray_tpu_torch/train/trainer.py",
            "ray_tpu_torch/utils/trees.py",
            "ray_tpu_torch/_private/__init__.py",
            "ray_tpu_torch/_private/runtime_perf.py",
            "tests/test_torch_dist_ranks.py",
            "tests/process_members.py"} <= names
    assert {f"ray_tpu_torch/rl/{m}.py" for m in RL_MODULES} <= names
    assert (ROOT / "ray_tpu_torch" / "csrc" / "flash_bwd.cu").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_imports_neither_jax_nor_ray_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_no_port_file_imports_cloudpickle():
    """The card's host has no cloudpickle: worker functions reach a worker
    process by reference, from a module it can import."""
    bad = [p.relative_to(ROOT).as_posix() for p in _port_files()
           if "cloudpickle" in set(_imported_roots(p))]
    assert not bad, bad


@pytest.mark.parametrize("name", ["compression", "ring", "collective"])
def test_collective_engine_needs_no_ml_dtypes(name):
    """The ring and its codecs round bf16 through torch: the card's host
    has no ml_dtypes (JAX's codecs import it)."""
    path = ROOT / "ray_tpu_torch" / "collective" / f"{name}.py"
    roots = set(_imported_roots(path))
    assert not roots & {*FORBIDDEN, "ml_dtypes"}, f"{name}.py imports {roots}"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ray_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_cache(cfg, 1, 8)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_engine.RaggedDecoder(params, cfg, slots=1, max_len=16,
                                    prompt_buckets=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.from_jax_params({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm.build_model("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm.build_model("moe-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(llama.llama2_size("moe-tiny"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.init_params(mlp.MLPConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm.LLMServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm_pool.PrefillWorker()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm_pool.LLMPool()


def test_train_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    opt = train.fused_adamw()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.init_train_state(
            lambda dev: llama.init_params(cfg, device=dev, master=True), opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg, master=True)
    path = str(tmp_path / "ck")
    train.save_state({"w": torch.ones(2)}, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.restore_state(path)


def test_rl_entry_points_raise_without_a_card(monkeypatch):
    """The learners, the learner groups, the policy server, the pool
    behind run_llm_pool and the actor-learner loop run on the card unless
    the caller asks for the CPU; only the env runners' placement is the
    CPU, which the algorithms pass explicitly."""
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl import appo, env_runner, models, rl_module
    from ray_tpu_torch.serve import runtime as serve_runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Env:
        def reset(self):
            return [0.0, 1.0]

        def step(self, a):
            return [0.0, 1.0], 0.0, True, {}

    for make in (lambda: rl.Learner(2, 2),
                 lambda: rl.BC(rl.BCConfig()),
                 lambda: rl.PPO(rl.PPOConfig(env_creator=Env, obs_dim=2)),
                 lambda: rl.IMPALA(rl.IMPALAConfig(env_creator=Env,
                                                   obs_dim=2)),
                 lambda: appo.APPO(appo.APPOConfig(env_creator=Env,
                                                   obs_dim=2)),
                 lambda: models.init_policy(0, 2, 2),
                 lambda: models.from_jax_params({}),
                 lambda: rl_module.DiscretePolicyModule(2, 2).init(0),
                 lambda: env_runner.EnvRunner(Env, 2, 2),
                 lambda: rl.VectorEnvRunner(Env, 2, 2),
                 lambda: rl.ActorLearnerLoop(rl.ActorLearnerConfig()),
                 lambda: rl.DQN(rl.DQNConfig(env_creator=Env, obs_dim=2)),
                 lambda: rl.SAC(rl.SACConfig(env_creator=Env)),
                 lambda: rl.SACLearner(3, 1),
                 lambda: rl.LearnerGroup(2, 2),
                 lambda: rl.SACLearnerGroup(3, 1),
                 lambda: rl.PolicyServer(
                     rl_module.DiscretePolicyModule(2, 2),
                     rl_module.DiscretePolicyModule(2, 2).init(0,
                                                               device="cpu")),
                 lambda: llm_pool.run_llm_pool(
                     runtime=serve_runtime.InProcessRuntime())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    algo = rl.PPO(rl.PPOConfig(env_creator=Env, obs_dim=2,
                               num_env_runners=1), device="cpu")
    try:
        assert algo.learner.device.type == "cpu"
        assert algo.runtime.get(algo.runtime.call(
            algo.runners[0], "sample", 2))["obs"].shape == (2, 2)
    finally:
        algo.stop()


def test_private_modules_stand_alone():
    """``ray_tpu_torch/_private/`` (the JAX package's ``_private``
    counterpart) imports neither package, and every module of ray_tpu's
    ``_private`` that imports jax has its counterpart there."""
    private = sorted((ROOT / "ray_tpu_torch" / "_private").glob("*.py"))
    assert [p.name for p in private] == ["__init__.py", "runtime_perf.py"]
    for path in private:
        assert not set(_imported_roots(path)) & set(FORBIDDEN), path.name
    jax_private = sorted(
        p.name for p in (ROOT / "ray_tpu" / "_private").glob("*.py")
        if {"jax", "jaxlib"} & set(_imported_roots(p)))
    assert set(jax_private) <= {p.name for p in private}, jax_private


def test_runtime_perf_families_raise_without_a_card(monkeypatch):
    from ray_tpu_torch._private import runtime_perf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in runtime_perf.RUNNERS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime_perf.run_benchmarks(quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime_perf.main(["--family", "pipeline", "--quick"])
