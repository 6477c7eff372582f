"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

Every ``.py`` under ``deepspeed_tpu_torch/``, ``chip_smoke.py`` and the
card tools under ``tools/`` is parsed with ``ast``; an import of ``jax``,
``jaxlib``, ``deepspeed_tpu`` (other than ``deepspeed_tpu_torch``),
``transformers`` or ``safetensors`` fails the test: the card's machine has
none of them (the HF importers read checkpoints on their own).  The entry
points, called
without a device while CUDA is absent, raise instead of running on the CPU.
"""

import ast
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import (KVCacheConfig, LlamaConfig, LlamaModel,
                                 MixtralConfig, MixtralModel,
                                 build_engine_v2, build_serving_frontend,
                                 init_distributed, init_inference,
                                 initialize)
from deepspeed_tpu_torch.utils.device import check_module_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu", "transformers",
             "safetensors")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.is_file(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_builders_read_only_the_ports_sources():
    """``nvcc`` compiles the top-level ``.cu`` files of the port's
    ``csrc/``, ``g++`` the two host sources of ``csrc/host/``; the repo's
    root ``csrc/`` (the JAX package's) never reaches either."""
    from deepspeed_tpu_torch.ops import op_builder

    port_csrc = ROOT / "deepspeed_tpu_torch" / "csrc"
    assert op_builder.CSRC == port_csrc
    cuda = op_builder.sources()
    assert cuda and all(p.parent == port_csrc and p.suffix == ".cu"
                        for p in cuda)
    host = [b.source for b in (op_builder.CPU_ADAM, op_builder.ASYNC_IO)]
    assert sorted(p.name for p in host) == ["aio_engine.cpp",
                                           "cpu_adam.cpp"]
    assert all(p.parent == port_csrc / "host" and p.is_file()
               for p in host)
    text = (ROOT / "deepspeed_tpu_torch" / "ops" / "op_builder.py"
            ).read_text()
    assert "parents[2] / \"csrc\"" not in text and "\"csrc/" not in text


def test_forbidden_rule_catches_the_jax_package():
    assert _forbidden("deepspeed_tpu.models.llama")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("transformers.models.llama")
    assert _forbidden("safetensors.torch")
    assert not _forbidden("deepspeed_tpu_torch.ops")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    _check_entry_points_raise(LlamaModel, LlamaConfig)


def test_mixtral_entry_points_raise_without_cuda(no_cuda):
    _check_entry_points_raise(MixtralModel, MixtralConfig)


@pytest.mark.parametrize("name", ["BertModel", "ResNetModel", "OPTModel"])
def test_ladder_models_raise_without_cuda(no_cuda, name):
    model_cls = getattr(deepspeed_tpu_torch, name)
    cfg_cls = getattr(deepspeed_tpu_torch, name.replace("Model", "Config"))
    cfg = cfg_cls.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_cls(cfg)
    model = model_cls(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(model=model, config={"train_micro_batch_size_per_gpu": 1})
    if name == "OPTModel":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_inference(model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine_v2(model, cache_config=KVCacheConfig(
                num_blocks=8, block_size=4, max_seq_len=64), prefill_chunk=8)


def _check_entry_points_raise(model_cls, cfg_cls):
    cfg = cfg_cls.tiny(num_layers=1, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_cls(cfg)
    model = model_cls(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_inference(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine_v2(model, cache_config=KVCacheConfig(
            num_blocks=8, block_size=4, max_seq_len=64), prefill_chunk=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serving_frontend(model, cache_config=KVCacheConfig(
            num_blocks=8, block_size=4, max_seq_len=64), prefill_chunk=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(model=model, config={"train_micro_batch_size_per_gpu": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()


def test_engine_refuses_a_model_on_another_device():
    model = LlamaModel(LlamaConfig.tiny(num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        check_module_device(model, torch.device("cuda"))
    with pytest.raises(ValueError, match="unsupported device"):
        build_engine_v2(model, device="meta")


def test_package_exports():
    for name in deepspeed_tpu_torch.__all__:
        assert hasattr(deepspeed_tpu_torch, name), name
    # the sequence-parallel surface, where the JAX package has it
    assert {"sequence_parallel", "DistributedAttention",
            "get_sequence_parallel_group", "get_sequence_parallel_rank",
            "get_sequence_parallel_world_size"} <= set(
                deepspeed_tpu_torch.__all__)
    from deepspeed_tpu.runtime import sequence_parallel as jax_sp
    assert deepspeed_tpu_torch.sequence_parallel.__all__ == jax_sp.__all__
