"""The port package stands alone and defaults to the card.

* ``import deepspeed_tpu_torch`` (every module of it, the robustness
  plane's ``comm/recovery.py``, ``elasticity/``, ``launcher/`` and
  ``cli_utils.py`` among them, and ``chip_smoke.py``) in a fresh
  interpreter leaves ``jax``, ``deepspeed_tpu`` and ``transformers`` out
  of ``sys.modules``;
* no module of the port, and not ``chip_smoke.py``, has an import of
  ``jax``, ``deepspeed_tpu`` or ``transformers`` anywhere in its source
  (``module_inject`` reads Hugging Face models by duck typing);
* with no CUDA, the entry points raise unless ``device="cpu"`` is given.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.models.gpt import GPT, gpt_config, init_kv_cache
from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.serving.kv_cache import init_arena

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepspeed_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu", "transformers")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_jax_package_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


# the training robustness plane's modules, which the walk below must reach
ROBUSTNESS_MODULES = (
    "deepspeed_tpu_torch.runtime.stability", "deepspeed_tpu_torch.runtime.fault_tolerance",
    "deepspeed_tpu_torch.comm.recovery", "deepspeed_tpu_torch.elasticity.elasticity",
    "deepspeed_tpu_torch.elasticity.elastic_agent", "deepspeed_tpu_torch.launcher.runner",
    "deepspeed_tpu_torch.launcher.launch", "deepspeed_tpu_torch.launcher.multinode_runner",
    "deepspeed_tpu_torch.cli_utils")


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepspeed_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'deepspeed_tpu', 'transformers'))\n"
        f"missing = sorted(set({ROBUSTNESS_MODULES!r}) - set(sys.modules))\n"
        "print(len([k for k in sys.modules if k.startswith('deepspeed_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "assert not missing, missing\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def tiny_cfg():
    return gpt_config("tiny", dtype="float32")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = tiny_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        init_arena(cfg, 4, 8)
    with pytest.raises(RuntimeError):
        init_kv_cache(cfg, 1, 8)
    model = GPT(cfg, device="cpu", seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.init_serving(model=model, config={"dtype": "float32"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.ServingEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.initialize(model=model, config={"train_micro_batch_size_per_gpu": 1})
    engine, *_ = dst.initialize(model=model, device="cpu",
                                config={"train_micro_batch_size_per_gpu": 1})
    assert engine.device == torch.device("cpu")
    assert engine.optimizer.table.device == torch.device("cpu")
    eng = dst.init_serving(model=model, device="cpu", config={
        "dtype": "float32", "block_size": 8, "num_blocks": 16,
        "max_batch_size": 2, "prefill_chunk": 8})
    assert eng.device == torch.device("cpu")
    out = eng.submit([1, 2, 3], max_new_tokens=4).result()
    assert out == model.generate([[1, 2, 3]], 4)[0, 3:].tolist()


def test_accelerator_is_cuda_unless_cpu_is_asked_for(no_cuda, monkeypatch):
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    acc = get_accelerator()
    assert acc.device_name() == "cuda" and not acc.is_available()
    with pytest.raises(RuntimeError):
        acc.device()
    cpu = get_accelerator("cpu")
    assert cpu.device() == torch.device("cpu") and cpu.is_available()
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    assert get_accelerator().device_name() == "cpu"
    with pytest.raises(ValueError):
        get_accelerator("tpu")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here; the missing-compiler path "
                    "cannot be shown")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(builder, "BUILD_ROOT", tmp_path / "build_torch")
    with pytest.raises(builder.KernelBuildError, match="nvcc not found"):
        builder.build()


def test_build_directory_is_keyed_by_sources_and_ignored():
    assert builder.BUILD_ROOT == REPO / "build_torch"
    assert len(builder.source_hash()) == 16
    assert [p.name for p in builder.sources()] == [
        "block_sparse_attention.cu", "cross_entropy.cu", "decode_attention.cu",
        "flash_attention.cu", "fused_optim.cu"]
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build_torch/" in ignored


def test_public_surface():
    assert dst.__version__
    for name in ("init_serving", "ServingEngine", "DeepSpeedServingConfig", "initialize",
                 "DeepSpeedEngine", "DeepSpeedConfig", "DeepSpeedConfigError",
                 "init_inference", "InferenceEngine", "DeepSpeedInferenceConfig"):
        assert hasattr(dst, name)
    from deepspeed_tpu_torch import module_inject
    for name in ("inject_hf_model", "replace_transformer_layer", "is_hf_model",
                 "load_megatron_gpt", "policy_for_model", "InjectionPolicy",
                 "quantize_weight", "dequantize_weight", "quantize_block_params"):
        assert hasattr(module_inject, name)
