"""The NVMe tier's walk on the card (no JAX import: the card machine's
JAX lacks the models the CPU tests compare against).  ``train_batch``
replays everything up to the update and then walks the NVMe pieces: one
capture, AdamW once a piece a step, and the CPU-offload run's losses,
parameters and moments bit for bit.  Skips without a GPU."""

import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import filesystem_type

# head_dim 64, which the card's flash backward takes
DIMS = dict(vocab_size=128, n_positions=32, n_embd=128, n_layer=4, n_head=2)
STEPS, PIECE = 3, 4096


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    yield torch.device("cuda", 0)
    comm.destroy_process_group()


@pytest.mark.cuda
def test_cuda_graphed_nvme_walk_is_the_cpu_offload_step_bitwise(cuda_device, tmp_path):
    from deepspeed_tpu_torch.ops.cuda import fused_optim
    assert filesystem_type(str(tmp_path)) not in ("tmpfs", "ramfs")
    nvme = {"device": "nvme", "nvme_path": str(tmp_path)}
    cpu = {"device": "cpu"}
    ids = torch.randint(0, DIMS["vocab_size"], (1, 8, DIMS["n_positions"]),
                        generator=torch.Generator().manual_seed(0)).to(cuda_device)
    runs = {}
    for name, tier in (("nvme", nvme), ("cpu", cpu)):
        model = GPT(GPTConfig(dtype="float32", **DIMS), device=cuda_device, seed=0)
        eng = dst.initialize(model=model, device=cuda_device, seed=7, config={
            "train_micro_batch_size_per_gpu": 8, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 3, "offload_param": tier,
                                  "offload_optimizer": tier, "sub_group_size": PIECE}})[0]
        fused_optim.reset_counts()
        losses = [float(eng.train_batch(batch=(ids, ids))) for _ in range(STEPS)]
        assert eng.graphs.captures == 1
        assert fused_optim.fused_adam.launches == STEPS * len(eng.optimizer.chunks)
        assert eng.optimizer.streamed == (name == "nvme")
        runs[name] = (losses, eng.get_fp32_params(), eng.optimizer.state_dict())
        eng.close()
        comm.destroy_process_group()
    (la, pa, sa), (lb, pb, sb) = runs["nvme"], runs["cpu"]
    assert la == lb
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(sa[m][k].cpu(), sb[m][k].cpu()) for m in ("mu", "nu") for k in pa)
