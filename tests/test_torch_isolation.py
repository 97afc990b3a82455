"""The port stands alone: no JAX, nothing of ray_tpu, no silent CPU runs."""

import ast
import pathlib

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.models import decode_engine, llama

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
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
    assert {"chip_smoke.py", "ray_tpu_torch/ops/flash_attention.py",
            "ray_tpu_torch/models/decode_engine.py",
            "ray_tpu_torch/train/optim.py",
            "ray_tpu_torch/train/step.py"} <= names
    assert (ROOT / "ray_tpu_torch" / "csrc" / "flash_bwd.cu").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_imports_neither_jax_nor_ray_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


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


def test_train_entry_points_raise_without_a_card(monkeypatch):
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
