"""The serving resilience plane on the card: the stream ordering of the
tiering copies and the bounded dispatch worker's device and stream.

Every test here is ``cuda``-marked and skips without an NVIDIA GPU; the
CPU parity of the same code with ``deepspeed_tpu`` is
``tests/test_torch_kv_tiering.py`` and
``tests/test_torch_serving_resilience.py``.  On the card:
``python -m pytest tests/test_torch_resilience_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.serving.kv_tiering import KVTieringManager


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tiering copies' stream and pinned memory and "
                    "the bounded worker's stream exist only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def prompts_of(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for n in lens]


def generated(model, prompt, n):
    return model.generate([prompt], n)[0, len(prompt):].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_copy_ring_orders_around_the_engine_stream(cuda_device, dtype, tmp_path):
    """A spill issued right behind ~50 ms of queued work that writes the
    blocks reads the written bytes into a pinned host tensor (the copies
    run on the engine stream and the spill waits for them); a read queued
    on the engine stream right after a restage sees the restored bytes."""
    shape = (4, 40, 16, 2, 64)
    kp = torch.randn(shape, device=cuda_device).to(dtype)
    vp = torch.randn(shape, device=cuda_device).to(dtype)
    engine = torch.cuda.current_stream(cuda_device)
    mgr = KVTieringManager(str(tmp_path), host_cache_bytes=1 << 30, stream=engine)
    try:
        blocks = [5, 9, 11, 2, 30, 31, 17]
        torch.cuda._sleep(100_000_000)
        kp[:, blocks] = 7.0
        vp[:, blocks] = -3.0
        mgr.spill(1, blocks, kp, vp, tokens=100)
        host = mgr.store.get("kvseq/1/1")
        assert host.is_pinned()
        assert host[0].eq(7.0).all() and host[1].eq(-3.0).all()
        dest = [20, 21, 22, 23, 24, 25, 26]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        kp[:, dest] = 0.0
        mgr.restage(1, kp, vp, dest)
        n = kp[:, dest].numel()
        assert kp[:, dest].float().sum().item() == 7.0 * n
        assert vp[:, dest].float().sum().item() == -3.0 * n
    finally:
        mgr.close()


@pytest.mark.cuda
def test_cuda_tiered_engine_matches_generate(cuda_device):
    """The serving engine with tiering, bounded dispatch and a preempting
    arena gives generate()'s tokens (head_dim 64, block 16)."""
    model = GPT(GPTConfig(vocab_size=256, n_positions=256, n_embd=128, n_layer=2, n_head=2,
                          dtype="float32"), device=cuda_device, seed=0)
    eng = dst.init_serving(model=model, device=cuda_device, config={"serving": dict(
        block_size=16, num_blocks=12, max_batch_size=4, prefill_chunk=32, dtype="float32",
        kv_tiering=True, kv_host_cache_bytes=200_000, kv_spill_chunk_blocks=2,
        serve_step_timeout_s=30.0)})
    prompts = prompts_of(4, (40, 70, 25, 55, 33), 256)
    mnts = [30, 24, 40, 20, 28]
    futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, mnts)]
    eng.run()
    for p, m, f in zip(prompts, mnts, futs):
        assert f.token_ids == generated(model, p, m)
    assert eng.sched.spill_count > 0 and eng.sched.restage_count > 0
    eng.close()


@pytest.mark.cuda
def test_cuda_bounded_dispatch_runs_on_the_engine_stream(cuda_device):
    """The engine is made under a side stream and driven from the default
    one: every dispatch, inline or on the bounded worker, runs with the
    engine's device and stream current, and the tokens equal generate()'s."""
    model = GPT(GPTConfig(vocab_size=256, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                          dtype="float32"), device=cuda_device, seed=0)
    stream = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(stream):
        eng = dst.init_serving(model=model, device=cuda_device, config={"serving": dict(
            block_size=16, num_blocks=32, max_batch_size=4, prefill_chunk=16,
            dtype="float32", serve_step_timeout_s=30.0)})
    assert eng._stream == stream
    where = []
    inner = eng.module.paged_step

    def recorded(*args):
        where.append((torch.cuda.current_device(), torch.cuda.current_stream(cuda_device)))
        return inner(*args)
    eng.module.paged_step = recorded
    prompts = prompts_of(8, (20, 33, 9), 256)
    futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run()
    for p, f in zip(prompts, futs):
        assert f.token_ids == generated(model, p, 10)
    assert eng._bounded.stats()["calls"] > 0
    assert set(where) == {(cuda_device.index, stream)}
    eng.close()
