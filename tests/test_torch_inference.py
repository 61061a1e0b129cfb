"""Parity of the port's inference engine (``deepspeed_tpu_torch/inference/``,
``deepspeed_tpu_torch.init_inference``) with ``deepspeed_tpu/inference/``
on the CPU, for a dense GPT and an MoE one (top-1 and top-2).

Weights come from the JAX init (matrices scaled up so greedy streams vary)
and reach the port through ``params_from_jax``; prompts are made with
numpy from a seed.  Tolerances, fp32: logits within 1e-5 of max(1, the
reference's largest magnitude); greedy tokens identical (the engines pad
prompts to the same 64-token bucket, so an MoE gate sees the same rows at
the published capacity factor 1.0, drops included).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import gpt_from_jax

TOL = 1e-5
BASE = dict(vocab_size=300, n_positions=96, n_embd=64, n_layer=2, n_head=4)
MODELS = {
    "dense": {},
    "moe-top1": dict(moe_num_experts=4, moe_top_k=1, moe_expert_hidden=96,
                     moe_eval_capacity_factor=1.0, moe_min_capacity=2),
    "moe-top2": dict(moe_num_experts=4, moe_top_k=2, moe_expert_hidden=96,
                     moe_eval_capacity_factor=1.0, moe_min_capacity=2),
}


def models(name, seed=0, scale=3.0):
    """(JAX model, JAX params, port model) on the same weights."""
    kw = dict(BASE, **MODELS[name])
    jcfg = jgpt.GPTConfig(dtype="float32", **kw)
    tree = jax.tree.map(lambda a: np.asarray(a) * (scale if np.ndim(a) >= 2 else 1.0),
                        jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(seed)))
    port = gpt_from_jax(tgpt.GPTConfig(dtype="float32", **kw), tree, device="cpu")
    return jgpt.GPT(jcfg), jax.tree.map(jnp.asarray, tree), port


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"max-abs error over max(1, |ref|) {err:.3e} > {tol}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_generate_match_jax(name):
    """Logits of a batch, and greedy tokens: a bucketed prompt (padded to
    64) and one whose bucket would pass n_positions (the exact length)."""
    jmodel, jparams, port = models(name, seed=1)
    jeng = deepspeed_tpu.init_inference(model=jmodel, params=jparams,
                                        config={"dtype": "float32"})
    teng = dst.init_inference(model=port, device="cpu", config={"dtype": "float32"})
    assert teng.module is port
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 300, (2, 11)).astype(np.int32)
    assert_close(teng(ids).numpy(), np.asarray(jeng(ids)))
    for prompt_len, new in ((11, 12), (70, 10)):
        prompt = rng.integers(1, 300, (2, prompt_len)).astype(np.int32)
        want = np.asarray(jeng.generate(prompt, max_new_tokens=new))
        got = teng.generate(prompt, max_new_tokens=new).numpy()
        np.testing.assert_array_equal(got, want)
        assert len(set(got[0, prompt_len:].tolist())) > 1, "degenerate stream tests nothing"


def test_moe_generate_at_no_drop_factor_equals_generate():
    """At an eval capacity factor >= the experts' count nothing drops, so the
    bucket's pad rows change no real token: the engine's tokens are the
    model's own generate()'s."""
    kw = dict(BASE, **dict(MODELS["moe-top2"], moe_eval_capacity_factor=4.0))
    jcfg = jgpt.GPTConfig(dtype="float32", **kw)
    tree = jax.tree.map(lambda a: np.asarray(a) * 3.0 if np.ndim(a) >= 2 else np.asarray(a),
                        jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(4)))
    port = gpt_from_jax(tgpt.GPTConfig(dtype="float32", **kw), tree, device="cpu")
    teng = dst.init_inference(model=port, device="cpu", config={"dtype": "float32"})
    prompt = np.random.default_rng(5).integers(1, 300, (3, 13)).astype(np.int32)
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=9).numpy(),
                                  port.generate(prompt, 9).numpy())


@pytest.mark.parametrize("store", ["torch", "local"])
def test_load_checkpoint_takes_a_training_checkpoint(tmp_path, store):
    """An MoE engine trained a step and saved: a fresh inference engine
    over other weights loads the tag and gives the trained model's logits,
    in fp32 and cast to bf16, each into a model of its own: the model it
    was given keeps its weights."""
    _, _, port = models("moe-top1", seed=3)
    eng, *_ = dst.initialize(model=port, device="cpu", config={
        "train_micro_batch_size_per_gpu": 2, "checkpoint": {"engine": store},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    ids = np.random.default_rng(7).integers(1, 300, (1, 2, 12)).astype(np.int32)
    eng.train_batch(batch=(ids, ids))
    eng.save_checkpoint(str(tmp_path))
    cfg = tgpt.GPTConfig(dtype="float32", **BASE, **MODELS["moe-top1"])
    trained = tgpt.gpt_forward(cfg, port.param_tree(), torch.from_numpy(ids[0]))
    fresh = tgpt.GPT(cfg, device="cpu", seed=11)
    before = {n: p.clone() for n, p in fresh.named_parameters()}
    teng = dst.init_inference(model=fresh, device="cpu", config={"dtype": "float32"})
    assert teng.module is fresh and not torch.allclose(teng(ids[0]), trained)
    assert teng.load_checkpoint(str(tmp_path)) is teng
    assert teng.module is not fresh
    assert_close(teng(ids[0]).numpy(), trained.detach().numpy(), tol=0.0)
    assert all(torch.equal(p, before[n]) for n, p in fresh.named_parameters())
    beng = dst.init_inference(model=fresh, device="cpu", config={"dtype": "bf16"})
    beng.load_checkpoint(str(tmp_path), tag="global_step1")
    assert beng.module is not fresh and beng.module.wte.dtype == torch.bfloat16
    assert fresh.wte.dtype == torch.float32
    assert torch.equal(beng.module.blocks[1].moe.experts.wi,
                       port.blocks[1].moe.experts.wi.to(torch.bfloat16))
    assert torch.isfinite(beng(ids[0])).all()


def test_load_checkpoint_leaves_a_training_engines_model_alone(tmp_path):
    """A training engine keeps its fp32 masters in the model it was given;
    an fp32 inference engine over that same model serves it as it is, and
    loading an older checkpoint into the inference engine changes neither
    the model nor the training engine's next step."""
    _, _, port = models("moe-top2", seed=5)
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}
    eng, *_ = dst.initialize(model=port, device="cpu", config=config)
    _, _, twin = models("moe-top2", seed=5)
    ref, *_ = dst.initialize(model=twin, device="cpu", config=config)
    batches = np.random.default_rng(8).integers(1, 300, (3, 1, 2, 12)).astype(np.int32)
    for b in batches[:2]:
        eng.train_batch(batch=(b, b))
        ref.train_batch(batch=(b, b))
    eng.save_checkpoint(str(tmp_path), tag="early")
    cfg = tgpt.GPTConfig(dtype="float32", **BASE, **MODELS["moe-top2"])
    early = tgpt.gpt_forward(cfg, port.param_tree(), torch.from_numpy(batches[0, 0]))
    eng.train_batch(batch=(batches[2], batches[2]))
    ref.train_batch(batch=(batches[2], batches[2]))
    masters = {n: p.clone() for n, p in port.named_parameters()}
    teng = dst.init_inference(model=port, device="cpu", config={"dtype": "float32"})
    assert teng.module is port
    teng.load_checkpoint(str(tmp_path), tag="early")
    assert teng.module is not port
    assert_close(teng(batches[0, 0]).numpy(), early.detach().numpy(), tol=0.0)
    assert all(torch.equal(p, masters[n]) for n, p in port.named_parameters())
    loss = eng.train_batch(batch=(batches[0], batches[0]))
    assert float(loss) == float(ref.train_batch(batch=(batches[0], batches[0])))
    assert all(torch.equal(p, dict(twin.named_parameters())[n])
               for n, p in port.named_parameters())


@pytest.mark.parametrize("config", [{"max_out_tokens": 64}, {"checkpoint": "ckpt.json"},
                                    {"min_out_tokens": 2}, {"moe": {"num_experts": 4}},
                                    {"tensor_parallel": {"enabled": False}}])
def test_config_keys_the_port_does_not_read_raise(config):
    _, _, port = models("dense")
    with pytest.raises(ValueError, match="not read by the port's engine"):
        dst.init_inference(model=port, device="cpu", config=config)


@pytest.mark.parametrize("config,match", [
    # int8 weights are ported; int4 is not
    ({"dtype": "int8", "quant": {"weight": {"num_bits": 4}}}, "int8"),
    ({"tensor_parallel": {"tp_size": 2}}, "tp_size"),
    ({"moe": {"ep_size": 2}}, "ep_size"),
    ({"enable_cuda_graph": True}, "enable_cuda_graph"),
    ({"telemetry": object()}, "telemetry"),
    ({"tracer": object()}, "telemetry and tracing"),
    ({"mesh": object()}, "mesh"),
])
def test_unported_options_raise_naming_their_roadmap_entry(config, match):
    _, _, port = models("dense")
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*ROADMAP"):
        dst.init_inference(model=port, device="cpu", **config)


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, port = models("dense")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.init_inference(model=port, config={"dtype": "float32"})
    assert dst.init_inference(model=port, device="cpu").device == torch.device("cpu")
