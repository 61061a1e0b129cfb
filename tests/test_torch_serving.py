"""Parity of the port's serving engine (``deepspeed_tpu_torch/serving/``) with
``deepspeed_tpu/serving/`` on the CPU, fp32.

* The port's ``ServingEngine`` and the JAX ``ServingEngine`` serve the same
  staggered requests on the same weights (JAX init, converted through
  ``params_from_jax``); outputs are token-identical to each other and to
  JAX ``generate()``, also when arena pressure forces evict -> recompute.
* The host control plane (allocator, scheduler, prefix cache) runs the JAX
  package's own unit cases (``tests/unit/serving/test_{kv_cache,scheduler,
  prefix_cache}.py``) with their classes rebound to the port's.
* Knobs outside this slice raise instead of being ignored.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.serving import DeepSpeedServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import gpt_from_jax
from deepspeed_tpu_torch.serving import kv_cache as port_kv
from deepspeed_tpu_torch.serving import prefix_cache as port_prefix
from deepspeed_tpu_torch.serving import scheduler as port_sched
from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from tests.unit.serving import test_kv_cache as jax_kv_cases
from tests.unit.serving import test_prefix_cache as jax_prefix_cases
from tests.unit.serving import test_scheduler as jax_sched_cases

MODEL = dict(vocab_size=256, n_positions=96, n_embd=32, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model) on the same weights; matrices
    scaled up so greedy streams vary."""
    jcfg = jgpt.GPTConfig(dtype="float32", **MODEL)
    jmodel = jgpt.GPT(jcfg)
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (4.0 if np.ndim(a) >= 2 else 1.0),
        jmodel.init_params(jax.random.PRNGKey(0)))
    port = gpt_from_jax(tgpt.GPTConfig(dtype="float32", **MODEL), tree,
                        device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


def serve_both(models, serving, prompts, mnts, stagger=6):
    """Serve ``prompts`` on the JAX and the port engine with the same
    staggered arrival; returns (jax futures, port futures, port engine)."""
    jmodel, jparams, port = models
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving),
                          params=jparams)
    teng = dst.init_serving(model=port, config={"serving": serving},
                            device="cpu")
    out = []
    for eng in (jeng, teng):
        futs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts[:stagger], mnts[:stagger])]
        for _ in range(3):
            eng.step()
        futs += [eng.submit(p, max_new_tokens=m)
                 for p, m in zip(prompts[stagger:], mnts[stagger:])]
        eng.run()
        out.append(futs)
    return out[0], out[1], jeng, teng


def test_continuous_batching_matches_jax_engine_and_generate(models):
    jmodel, jparams, port = models
    rng = np.random.default_rng(0)
    lens = [3, 9, 17, 30, 5, 21, 12, 40, 7, 26]
    mnts = [8, 12, 5, 7, 10, 6, 12, 4, 9, 11]
    prompts = [list(rng.integers(1, MODEL["vocab_size"], size=n)) for n in lens]
    serving = dict(block_size=8, num_blocks=64, max_batch_size=8,
                   prefill_chunk=16, dtype="float32")
    jfuts, tfuts, jeng, teng = serve_both(models, serving, prompts, mnts)
    for i, (p, m, jf, tf) in enumerate(zip(prompts, mnts, jfuts, tfuts)):
        assert tf.done and tf.token_ids == jf.token_ids, i
        ref = port.generate([p], m)[0, len(p):].tolist()
        assert tf.token_ids == ref, i
    # JAX generate() on a few of them (each prompt length compiles anew)
    for i in (0, 3, 7):
        jref = np.asarray(jmodel.generate(
            jparams, np.asarray(prompts[i], np.int32)[None], mnts[i]))
        assert tfuts[i].token_ids == jref[0, lens[i]:].tolist(), i
    assert len({t for f in tfuts for t in f.token_ids}) > len(tfuts)
    assert teng.sched.stats()["finished"] == len(tfuts)
    teng.alloc.check_consistent()


def test_eviction_recompute_matches_jax_engine(models):
    """Cumulative KV ~5x the arena: preemption, eviction and recompute on
    both engines, with the same token streams."""
    _, _, port = models
    rng = np.random.default_rng(1)
    lens = (10, 14, 6, 12, 9, 16)
    mnts = (20, 16, 24, 12, 18, 14)
    prompts = [list(rng.integers(1, MODEL["vocab_size"], size=n)) for n in lens]
    serving = dict(block_size=4, num_blocks=10, max_batch_size=4,
                   prefill_chunk=8, max_blocks_per_seq=9, dtype="float32")
    jfuts, tfuts, jeng, teng = serve_both(models, serving, prompts, mnts,
                                          stagger=len(prompts))
    assert teng.sched.preemption_count > 0 and teng.alloc.eviction_count > 0
    assert teng.sched.preemption_count == jeng.sched.preemption_count
    for p, m, jf, tf in zip(prompts, mnts, jfuts, tfuts):
        assert tf.token_ids == jf.token_ids
        assert tf.token_ids == port.generate([p], m)[0, len(p):].tolist()
    teng.alloc.check_consistent()


def test_snapshot_restore_continues_identically(models):
    _, _, port = models
    serving = {"block_size": 8, "num_blocks": 32, "max_batch_size": 2,
               "prefill_chunk": 8, "dtype": "float32"}
    prompt = [5, 17, 3, 99, 42]
    ref = port.generate([prompt], 10)[0, len(prompt):].tolist()
    eng = dst.init_serving(model=port, config=serving, device="cpu")
    eng.submit(prompt, max_new_tokens=10)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    assert snap["requests"][0]["generated"] == ref[:len(snap["requests"][0]["generated"])]
    fresh = dst.init_serving(model=port, config=serving, device="cpu")
    (fut,) = fresh.restore(snap)
    assert fut.result() == ref


def test_init_serving_config_path_and_engine_copy(models):
    """Nested config + kwargs, explicit kwargs win; a bf16 config serves a
    bf16 copy and leaves the caller's fp32 model alone."""
    _, _, port = models
    eng = dst.init_serving(model=port, config={"serving": {
        "block_size": 8, "num_blocks": 32, "max_batch_size": 2,
        "dtype": "float32"}}, device="cpu", max_batch_size=4)
    assert eng._config.max_batch_size == 4 and eng.module is port
    bf = dst.init_serving(model=port, config={"block_size": 8,
                                              "num_blocks": 32},
                          device="cpu")
    assert bf.module is not port and bf.module.wte.dtype == torch.bfloat16
    assert port.wte.dtype == torch.float32
    assert len(bf.submit([1, 2, 3], max_new_tokens=3).result()) == 3
    # params= (a state dict) is served instead of the model's own weights
    other = tgpt.GPT(port.cfg, device="cpu", seed=42)
    eng2 = dst.init_serving(model=port, params=other.state_dict(),
                            device="cpu", config={"dtype": "float32"})
    out = eng2.submit([1, 2, 3], max_new_tokens=5).result()
    assert out == other.generate([[1, 2, 3]], 5)[0, 3:].tolist()
    assert out != port.generate([[1, 2, 3]], 5)[0, 3:].tolist()


def test_submit_rejects_oversized_and_sampled(models):
    _, _, port = models
    eng = dst.init_serving(model=port, device="cpu", config={
        "block_size": 4, "num_blocks": 6, "max_batch_size": 2,
        "dtype": "float32"})
    with pytest.raises(port_kv.ArenaExhausted):
        eng.submit(list(range(1, 30)), max_new_tokens=20)
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new_tokens=1000)
    with pytest.raises(NotImplementedError):
        eng.submit([1, 2], max_new_tokens=4, temperature=0.7)
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new_tokens=4, slo="rt")


def test_deadline_expiry_frees_blocks(models):
    _, _, port = models
    eng = dst.init_serving(model=port, device="cpu", config={
        "block_size": 8, "num_blocks": 32, "max_batch_size": 2,
        "dtype": "float32", "deadline_ms": {"batch": 1.0}})
    clock = [0.0]
    eng._clock = lambda: clock[0]
    fut = eng.submit([1, 2, 3, 4], max_new_tokens=8, slo="batch")
    eng.step()
    clock[0] = 1.0
    eng.step()
    with pytest.raises(port_sched.DeadlineExceeded):
        fut.result()
    assert eng.alloc.blocks_in_use == 0
    eng.alloc.check_consistent()


@pytest.mark.parametrize("kwargs", [
    # tiering, bounded dispatch, telemetry and tracing are taken; a model seed is not
    {"model_seed": 3},
])
def test_out_of_slice_options_raise(models, kwargs):
    _, _, port = models
    config = dict(kwargs.pop("config", {}), dtype="float32")
    with pytest.raises((NotImplementedError, TypeError)):
        dst.init_serving(model=port, config=config, device="cpu", **kwargs)


def test_torch_dtype_property():
    assert DeepSpeedServingConfig().torch_dtype == torch.bfloat16
    assert DeepSpeedServingConfig(dtype="fp32").torch_dtype == torch.float32


@pytest.mark.cuda
def test_cuda_engine_refuses_shapes_the_kernel_lacks(models):
    """The paged kernel is compiled for block_size 16 and head_dim 64, 96,
    128 and 256: on CUDA the engine refuses any other (8 and 80 here) at
    construction, not at its first step, and takes 96 (GPT-NeoX-20B) and
    128 (LLaMA, BLOOM)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, _, port = models                            # head_dim 8
    serving = dict(block_size=16, num_blocks=16, max_batch_size=2,
                   prefill_chunk=8, dtype="float32")
    with pytest.raises(ValueError, match="head_dim"):
        dst.init_serving(model=port, config={"serving": serving}, device="cuda")
    small = dict(vocab_size=256, n_positions=96, n_layer=1, dtype="float32")
    d80 = tgpt.GPT(tgpt.GPTConfig(n_embd=160, n_head=2, **small), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        dst.init_serving(model=d80, config={"serving": serving}, device="cuda")
    neox = tgpt.GPT(tgpt.GPTConfig(n_embd=192, n_head=2, **small), device="cuda")
    llama = tgpt.GPT(tgpt.llama_config(n_embd=256, n_head=2, n_kv_head=1, **small),
                     device="cuda")
    for model in (neox, llama):
        eng = dst.init_serving(model=model, config={"serving": serving}, device="cuda")
        out = eng.submit([1, 2, 3], max_new_tokens=4).result()
        assert out == model.generate([[1, 2, 3]], 4)[0, 3:].tolist()


# --------------------------------------------------------------------------- #
# the JAX package's host control-plane cases, against the port's classes
# --------------------------------------------------------------------------- #
PORT_NAMES = {
    "ArenaExhausted": port_kv.ArenaExhausted,
    "PagedKVAllocator": port_kv.PagedKVAllocator,
    "PrefixCache": port_prefix.PrefixCache,
    "DeepSpeedServingConfig": DeepSpeedServingConfig,
    "QueueFull": port_sched.QueueFull,
    "Request": port_sched.Request,
    "ServingScheduler": port_sched.ServingScheduler,
    "DECODE": port_sched.DECODE,
    "PREFILL": port_sched.PREFILL,
    "WAITING": port_sched.WAITING,
}
CASE_MODULES = {"kv_cache": jax_kv_cases, "scheduler": jax_sched_cases,
                "prefix_cache": jax_prefix_cases}


def port_bound(module):
    """The module's namespace with the JAX serving classes replaced by the
    port's, and its own functions rebound to that namespace."""
    ns = dict(vars(module))
    ns.update({k: v for k, v in PORT_NAMES.items() if k in ns})
    for name, obj in list(ns.items()):
        if isinstance(obj, types.FunctionType) and obj.__module__ == module.__name__:
            ns[name] = types.FunctionType(obj.__code__, ns, name,
                                          obj.__defaults__, obj.__closure__)
    leaked = [k for k, v in ns.items()
              if getattr(v, "__module__", "").startswith("deepspeed_tpu.")]
    assert not leaked, f"JAX-package names left unbound: {leaked}"
    return ns


HOST_CASES = [(mod, name) for mod, m in sorted(CASE_MODULES.items())
              for name in sorted(vars(m)) if name.startswith("test_")]


@pytest.mark.parametrize("mod,case", HOST_CASES,
                         ids=[f"{m}::{c}" for m, c in HOST_CASES])
def test_host_control_plane_case(mod, case):
    port_bound(CASE_MODULES[mod])[case]()
