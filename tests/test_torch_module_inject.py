"""Parity of the port's ``module_inject`` (``deepspeed_tpu_torch/module_inject/``)
and int8 ``init_inference`` with ``deepspeed_tpu/module_inject/`` and the JAX
inference engine, on the CPU.

* Tiny ``transformers`` models of the seven decoder policies (GPT-2, OPT,
  GPT-Neo, BLOOM, LLaMA with and without GQA, GPT-J, GPT-NeoX parallel and
  sequential), built offline from configs with seeded weights as the JAX
  package's own ``tests/unit/inference/test_injection.py`` builds them, go
  through ``init_inference`` in both packages.  Tolerances, fp32: port vs
  HF the JAX tests' own (2e-4, 3e-4 for GPT-J and NeoX, 3e-3 for BLOOM,
  whose embedding norm is folded into the table); port vs JAX 1e-5 of
  max(1, |JAX|) (both sum in fp32, in other orders); greedy tokens equal.
* The port's policies give JAX's policy output, carried through
  ``models/convert.py``, bit for bit in fp32.
* int8 (``dtype="int8"``): the ``q8`` payloads equal JAX's except by 1
  where ``w * 127 / max |w|`` is exactly a half-integer, a tie that JAX's
  jitted division (a reciprocal product, XLA's rewrite) and the port's
  puts on either side (counted; any other difference at most 1e-6 of the
  elements), the scales within 1e-6 relative, and the bf16 logits within
  ``BF16_TOL`` of max(1, |JAX|): both compute in bf16 and round at other
  points, a few bf16 ulps (2^-8 relative each) through two layers.
* ``load_megatron_gpt`` against JAX's on a synthetic checkpoint.
* What JAX refuses the port refuses: an unknown ``model_type``, GPT-Neo's
  local attention, NeoX's ``gelu_fast``; an encoder model raises naming
  its ROADMAP entry.
* ``chip_smoke.py``'s HF-layout stand-ins (``hf_standin``), without
  ``transformers``: at GPT-J's head_dim 256 and NeoX's 96 they inject back
  to the model's own weights, give its tokens and JAX's, and (where
  ``transformers`` is installed) have a real model's keys and shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.module_inject import megatron as jmegatron
from deepspeed_tpu.module_inject import policies as jpolicies
from deepspeed_tpu.module_inject import quantization as jquant
from deepspeed_tpu_torch import module_inject as tmi
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_jax

TOL = 1e-5
BF16_TOL = 3e-2
VOCAB = 97
IDS = np.random.default_rng(0).integers(0, VOCAB, size=(2, 12))


def hf_model(kind):
    """A tiny HF causal LM of ``kind``, seeded (JAX's test configs)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(sum(map(ord, kind)))
    T = transformers
    if kind == "gpt2":
        return T.GPT2LMHeadModel(T.GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=32,
                                              n_layer=2, n_head=4)).eval()
    if kind == "opt":
        return T.OPTForCausalLM(T.OPTConfig(
            vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, ffn_dim=128,
            num_attention_heads=4, max_position_embeddings=64, activation_function="relu",
            word_embed_proj_dim=32, do_layer_norm_before=True)).eval()
    if kind == "gpt_neo":
        return T.GPTNeoForCausalLM(T.GPTNeoConfig(
            vocab_size=VOCAB, max_position_embeddings=64, hidden_size=32, num_layers=2,
            attention_types=[[["global"], 2]], num_heads=4)).eval()
    if kind == "bloom":
        return T.BloomForCausalLM(T.BloomConfig(vocab_size=VOCAB, hidden_size=32, n_layer=2,
                                                n_head=4)).eval()
    if kind in ("llama", "llama-gqa"):
        return T.LlamaForCausalLM(T.LlamaConfig(
            vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2 if kind == "llama-gqa" else 4, intermediate_size=64,
            max_position_embeddings=64)).eval()
    if kind == "gptj":
        return T.GPTJForCausalLM(T.GPTJConfig(vocab_size=VOCAB, n_positions=64, n_embd=32,
                                              n_layer=2, n_head=4, rotary_dim=4,
                                              tie_word_embeddings=False)).eval()
    return T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
        vocab_size=VOCAB, max_position_embeddings=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        rotary_pct=0.5 if kind == "neox-parallel" else 0.25,
        use_parallel_residual=kind == "neox-parallel")).eval()


# kind: port vs HF tolerance (the JAX tests')
KINDS = {"gpt2": 2e-4, "opt": 2e-4, "gpt_neo": 2e-4, "bloom": 3e-3, "llama": 2e-4,
         "llama-gqa": 2e-4, "gptj": 3e-4, "neox-parallel": 3e-4, "neox-sequential": 3e-4}


@pytest.fixture(scope="module")
def models():
    return {}


def get(models, kind):
    if kind not in models:
        models[kind] = hf_model(kind)
    return models[kind]


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"max-abs error over max(1, |ref|) {err:.3e} > {tol}"


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_hf_decoders_match_hf_and_jax(models, kind):
    hf = get(models, kind)
    with torch.no_grad():
        ref = hf(torch.tensor(IDS)).logits.float().numpy()
    jeng = deepspeed_tpu.init_inference(hf, dtype="float32")
    teng = dst.init_inference(hf, dtype="float32", device="cpu")
    port = teng(IDS).numpy()[:, :, :VOCAB]
    np.testing.assert_allclose(port, ref, atol=KINDS[kind], rtol=KINDS[kind])
    assert_close(port, np.asarray(jeng(IDS))[:, :, :VOCAB])
    jtok = np.asarray(jeng.generate(IDS[:1], max_new_tokens=6))
    np.testing.assert_array_equal(teng.generate(IDS[:1], max_new_tokens=6).numpy(), jtok)
    if kind == "llama-gqa":
        assert teng.module.cfg.kv_heads == 2


# the config fields the policies set
POLICY_FIELDS = ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "n_kv_head",
                 "activation", "ln_eps", "untied_head", "head_bias", "position_encoding",
                 "rope_dim", "rope_interleaved", "rope_theta", "block_type",
                 "intermediate_size", "norm", "mlp_type", "use_bias", "vocab_multiple")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_policy_equals_jax_policy_through_convert(models, kind):
    hf = get(models, kind)
    jcfg, jparams = jpolicies.policy_for_model(hf).build(hf)
    tcfg, sd = tmi.policy_for_model(hf).build(hf, device="cpu")
    jsd = params_from_jax(jparams)
    assert set(sd) == set(jsd)
    for k, t in sd.items():
        assert t.dtype == torch.float32 and torch.equal(t, jsd[k]), k
    for f in POLICY_FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_injected_leaves_are_copies_in_the_engines_dtype(models):
    hf = get(models, "gpt2")
    eng = dst.init_inference(hf, dtype="bf16", device="cpu")
    w = eng.module.blocks[0].qkv_w
    assert w.dtype == torch.bfloat16 and eng.module.cfg.dtype == torch.bfloat16
    src = hf.state_dict()["transformer.h.0.attn.c_attn.weight"]
    assert torch.equal(w, src.to(torch.bfloat16))
    f32 = tmi.inject_hf_model(hf, device="cpu")[0].blocks[0].qkv_w
    assert torch.equal(f32, src) and f32.data_ptr() != src.data_ptr()


def test_caller_params_win_over_the_injected_ones(models):
    hf = get(models, "gpt2")
    _, sd = tmi.inject_hf_model(hf, device="cpu")
    zeroed = {k: torch.zeros_like(v) for k, v in sd.items()}
    eng = dst.init_inference(hf, dtype="fp32", device="cpu", params=zeroed)
    out = eng.forward([[5, 11]])
    assert torch.all(out == out[0, 0, 0])


def test_a_custom_policy_passes_through(models):
    hf = get(models, "gpt2")
    calls = []

    class Counting(tmi.HFGPT2Policy):
        model_types = ("not-gpt2",)

        def convert(self, hc, sd, place):
            calls.append(hc.model_type)
            return super().convert(hc, sd, place)
    eng = dst.init_inference(hf, dtype="fp32", device="cpu", policy=Counting())
    assert calls == ["gpt2"]
    assert_close(eng(IDS).numpy(), dst.init_inference(hf, dtype="fp32", device="cpu")(IDS))


# --------------------------------------------------------------------------- #
# int8
# --------------------------------------------------------------------------- #
def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 64, 48)) * rng.uniform(0.01, 2, (3, 1, 48))).astype(np.float32)
    w[0, :, 0] = 0.0                                   # a zero column: scale at its floor
    w[1, :, 3] = 0.0                                   # scale 1: exact ties at x.5
    w[1, :9, 3] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 3.5]
    j = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    t = tmi.quantize_weight(torch.from_numpy(w))
    assert t["q8"].dtype == torch.int8 and t["scale"].dtype == torch.float32
    assert t["scale"].shape == (3, 1, 48)
    np.testing.assert_allclose(t["scale"].numpy(), np.asarray(j["scale"]), rtol=1e-6, atol=0)
    diff = np.abs(t["q8"].numpy().astype(np.int32) - np.asarray(j["q8"], np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= max(1, 1e-6 * w.size)
    np.testing.assert_array_equal(t["q8"][1, :9, 3].numpy(), [127, 0, 2, 2, 0, -2, 126, -126, 4])
    deq = tmi.dequantize_weight(t, torch.float32)
    assert (deq - torch.from_numpy(w)).abs().max() <= t["scale"].max() / 2 + 1e-6
    with pytest.raises(NotImplementedError, match="8 bits.*Queue 1 entry 8"):
        tmi.quantize_weight(torch.from_numpy(w), bits=4)
    # over a tree (the port's list of blocks; JAX's stacked dict, unjitted:
    # its division is the port's, so every payload agrees)
    tree = {"wte": torch.from_numpy(w[0]),
            "blocks": [{"qkv_w": torch.from_numpy(w[2]), "qkv_b": torch.zeros(48)}]}
    q = tmi.quantize_block_params(tree)
    assert tmi.is_quantized_leaf(q["blocks"][0]["qkv_w"]) and q["wte"] is tree["wte"]
    assert q["blocks"][0]["qkv_b"] is tree["blocks"][0]["qkv_b"]
    jtree = jquant.quantize_block_params({"blocks": {"qkv_w": jnp.asarray(w[2:])}})
    np.testing.assert_array_equal(q["blocks"][0]["qkv_w"]["q8"].numpy(),
                                  np.asarray(jtree["blocks"]["qkv_w"]["q8"][0]))


def payload_differences(q8, jq8, w):
    """(elements off by one at an exact tie, any other difference) of the
    port's and JAX's int8 payloads of the weight ``w``."""
    wf = w.double().numpy()
    half = 2 * wf * 127 / np.maximum(np.abs(wf).max(axis=-2, keepdims=True), 1e-12)
    tie = (np.abs(half - np.round(half)) < 1e-9) & (np.round(half) % 2 == 1)
    diff = np.abs(q8.numpy().astype(np.int32) - np.asarray(jq8, np.int32))
    return int(((diff == 1) & tie).sum()), int(((diff > 0) & ~((diff == 1) & tie)).sum())


@pytest.mark.parametrize("kind", ["gptj", "neox-parallel", "llama-gqa"])
def test_int8_init_inference_matches_jax(models, kind):
    hf = get(models, kind)
    jeng = deepspeed_tpu.init_inference(hf, dtype="int8")
    teng = dst.init_inference(hf, dtype="int8", device="cpu")
    assert teng.quantize_weights and teng.module.quantized
    assert teng.module.cfg.dtype == torch.bfloat16
    bf16 = tmi.inject_hf_model(hf, dtype=torch.bfloat16, device="cpu")[0]
    jblocks = jeng.params["blocks"]
    n_elems = n_ties = n_other = 0
    for i, block in enumerate(teng.module.blocks):
        for k in tmi.QUANT_KEYS:
            q8, scale = getattr(block, k).q8, getattr(block, k).scale
            assert q8.dtype == torch.int8 and scale.dtype == torch.float32
            np.testing.assert_allclose(scale.numpy(), np.asarray(jblocks[k]["scale"][i]),
                                       rtol=1e-6, atol=0)
            ties, other = payload_differences(q8, jblocks[k]["q8"][i],
                                              getattr(bf16.blocks[i], k))
            n_ties, n_other, n_elems = n_ties + ties, n_other + other, n_elems + q8.numel()
    assert n_other <= 1e-6 * n_elems, f"{n_other} of {n_elems} payloads differ off a tie"
    assert n_ties <= 1e-3 * n_elems, f"{n_ties} ties of {n_elems} went the other way"
    assert_close(teng(IDS).float().numpy(), np.asarray(jeng(IDS), np.float32), BF16_TOL)
    # an int8 tree from JAX's engine reaches the port through convert.py
    from deepspeed_tpu_torch.models.convert import gpt_from_jax
    jtree = jax.tree.map(np.asarray, jeng.params)
    port = gpt_from_jax(teng.module.cfg, jtree, device="cpu")
    assert port.quantized
    assert torch.equal(port.blocks[0].qkv_w.q8,
                       torch.from_numpy(np.array(jblocks["qkv_w"]["q8"][0])))
    assert port.blocks[0].qkv_w.scale.dtype == torch.float32


def test_int8_config_reads_the_quant_switches():
    model = tgpt.GPT(tgpt.gpt_config("tiny", dtype="float32"), device="cpu", seed=0)
    off = dst.init_inference(model, device="cpu", dtype="int8", quant={"weight": {"enabled": False}})
    assert not off.module.quantized and off.module.cfg.dtype == torch.bfloat16
    on = dst.init_inference(model, device="cpu", dtype="int8")
    assert on.module.quantized and not model.quantized
    assert model.blocks[0].qkv_w.dtype == torch.float32          # the caller's model untouched
    with pytest.raises(ValueError, match="quant.activation"):
        dst.init_inference(model, device="cpu", dtype="int8", quant={"activation": {}})
    with pytest.raises(NotImplementedError, match="8 bits"):
        dst.init_inference(model, device="cpu", dtype="int8", quant={"weight": {"num_bits": 4}})
    ids = [[1, 2, 3, 4, 5]]
    assert on.generate(ids, max_new_tokens=4).shape == (1, 9)


# --------------------------------------------------------------------------- #
# Megatron-LM checkpoints
# --------------------------------------------------------------------------- #
def megatron_state(version, nested, L=2, E=32, H=4, V=64, P=48, seed=0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.2)
    flat = {"language_model.embedding.word_embeddings.weight": a(V, E),
            "language_model.embedding.position_embeddings.weight": a(P, E),
            "language_model.transformer.final_layernorm.weight": 1 + a(E),
            "language_model.transformer.final_layernorm.bias": a(E)}
    for i in range(L):
        b = f"language_model.transformer.layers.{i}."
        flat.update({b + "input_layernorm.weight": 1 + a(E), b + "input_layernorm.bias": a(E),
                     b + "attention.query_key_value.weight": a(3 * E, E),
                     b + "attention.query_key_value.bias": a(3 * E),
                     b + "attention.dense.weight": a(E, E), b + "attention.dense.bias": a(E),
                     b + "post_attention_layernorm.weight": 1 + a(E),
                     b + "post_attention_layernorm.bias": a(E),
                     b + "mlp.dense_h_to_4h.weight": a(4 * E, E),
                     b + "mlp.dense_h_to_4h.bias": a(4 * E),
                     b + "mlp.dense_4h_to_h.weight": a(E, 4 * E),
                     b + "mlp.dense_4h_to_h.bias": a(E)})
    if not nested:
        return dict({f"model.{k}": v for k, v in flat.items()}, checkpoint_version=version)
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return {"model": tree, "checkpoint_version": version}


@pytest.mark.parametrize("nested", [True, False])
@pytest.mark.parametrize("version", [1.0, 2.0, 3.0])
def test_load_megatron_gpt_matches_jax(version, nested):
    state = megatron_state(version, nested)
    jmodel, jparams = jmegatron.load_megatron_gpt(state, num_heads=4, dtype="float32")
    tmodel, sd = tmi.load_megatron_gpt(state, num_heads=4, device="cpu")
    jsd = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(jsd)
    for k in sd:
        assert torch.equal(sd[k], jsd[k]), k
    assert tmodel.cfg.padded_vocab == jmodel.cfg.padded_vocab == 64
    ids = np.random.default_rng(1).integers(0, 64, size=(1, 10))
    jl = np.asarray(jmodel.apply_with_cache(jparams, jnp.asarray(ids),
                                            jmodel.init_cache(1, 10))[0])
    tl = tmodel.apply_with_cache(torch.from_numpy(ids), tmodel.init_cache(1, 10))[0]
    assert_close(tl.numpy(), jl)


def test_load_megatron_gpt_refuses_what_it_cannot_read(tmp_path):
    state = megatron_state(2.0, nested=True)
    with pytest.raises(ValueError, match="num_heads"):
        tmi.load_megatron_gpt(state)
    with pytest.raises(NotImplementedError, match="Queue 1 entry 5"):
        tmi.load_megatron_gpt(["a.pt", "b.pt"], num_heads=4)
    path = tmp_path / "mp_rank_00.pt"
    torch.save(state, path)
    _, sd = tmi.load_megatron_gpt([str(path)], num_heads=4, device="cpu")
    assert torch.equal(sd["wte"], state["model"]["language_model"]["embedding"][
        "word_embeddings"]["weight"])


# --------------------------------------------------------------------------- #
# what is refused
# --------------------------------------------------------------------------- #
class Config:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class StandIn:
    def __init__(self, config, sd=None):
        self.config, self._sd = config, sd or {}

    def state_dict(self):
        return self._sd


def test_unsupported_model_type_raises_as_jax_does():
    from deepspeed_tpu.module_inject import inject_hf_model as jinject
    model = StandIn(Config(model_type="mamba"))
    for inject in (lambda: jinject(model), lambda: tmi.inject_hf_model(model, device="cpu")):
        with pytest.raises(ValueError, match="no injection policy for model_type='mamba'"):
            inject()


@pytest.mark.parametrize("kind", ["bert", "distilbert", "clip_text_model"])
def test_encoder_models_raise_naming_their_entry(kind):
    with pytest.raises(NotImplementedError,
                       match="no injection policy.*encoder.*Queue 1 entry 8"):
        dst.init_inference(StandIn(Config(model_type=kind)), device="cpu")


def test_gpt_neo_local_attention_and_gelu_fast_raise(models):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    local = transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(
        vocab_size=VOCAB, max_position_embeddings=64, hidden_size=32, num_layers=2,
        attention_types=[[["global", "local"], 1]], num_heads=4)).eval()
    with pytest.raises(AssertionError, match="local attention"):
        jpolicies.HFGPTNeoPolicy().build(local)
    with pytest.raises(NotImplementedError, match="local attention.*Queue 1 entry 8"):
        dst.init_inference(local, device="cpu", dtype="fp32")
    fast = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=VOCAB, max_position_embeddings=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=4, intermediate_size=64, hidden_act="gelu_fast")).eval()
    for build in (jpolicies.HFGPTNeoXPolicy().build,
                  lambda m: tmi.HFGPTNeoXPolicy().build(m, device="cpu")):
        with pytest.raises(NotImplementedError, match="activation 'gelu_fast'"):
            build(fast)


def test_other_models_raise_naming_their_entry():
    with pytest.raises(NotImplementedError, match="Queue 1 entry 8"):
        dst.init_inference(torch.nn.Linear(2, 2), device="cpu")


# --------------------------------------------------------------------------- #
# chip_smoke.py's HF-layout stand-ins, without transformers
# --------------------------------------------------------------------------- #
# GPT-J's and NeoX-20B's topologies at their head_dims (256, 96), 2 heads
STANDINS = {
    "gptj-6b": dict(vocab_size=300, n_positions=96, n_embd=512, n_head=2),
    "neox-20b": dict(vocab_size=300, n_positions=96, n_embd=192, n_head=2,
                     intermediate_size=256),
}


def standin(name, layers=2):
    """(the port's tiny model at ``name``'s topology, its stand-in), as
    ``chip_smoke.standin_model`` makes them at full width."""
    _, kw, _ = chip_smoke.FAMILY_CELLS[name]
    kw = dict(kw, n_layer=layers, **STANDINS[name])
    if name == "neox-20b":
        kw["activation"] = "gelu"
    kw["rope_dim"] = kw["n_embd"] // kw["n_head"] // 4
    model = tgpt.GPT(tgpt.GPTConfig(**kw, dtype="float32"), device="cpu", seed=1)
    with torch.no_grad():
        for p in model.parameters():       # biases and norms away from 0 and 1
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
            else:
                p.mul_(3.0)
        for leaf in ("wte", "lm_head", "lm_head_b"):
            if hasattr(model, leaf):
                getattr(model, leaf)[model.cfg.vocab_size:] = 0
        if name == "gptj-6b":            # the policy's placeholders
            for b in model.blocks:
                b.qkv_b.zero_()
                b.out_b.zero_()
                b.ln2_g.fill_(1.0)
                b.ln2_b.zero_()
    return model, chip_smoke.hf_standin(model, chip_smoke.INJECT_KINDS[name])


@pytest.mark.parametrize("name", sorted(STANDINS))
def test_standin_injects_back_to_the_model_and_matches_jax(name):
    model, hf = standin(name)
    assert model.cfg.head_dim == {"gptj-6b": 256, "neox-20b": 96}[name]
    eng = dst.init_inference(hf, dtype="float32", device="cpu")
    own = dict(model.named_parameters())
    for k, t in eng.module.named_parameters():
        assert torch.equal(t, own[k]), k
    jcfg, jparams = jpolicies.policy_for_model(hf).build(hf)
    tcfg, sd = tmi.policy_for_model(hf).build(hf, device="cpu")
    jsd = params_from_jax(jparams)
    assert set(sd) == set(jsd) and all(torch.equal(sd[k], jsd[k]) for k in sd)
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, 300, size=(1, 9))
    ref = model.generate(prompts, 10).numpy()
    np.testing.assert_array_equal(eng.generate(prompts, max_new_tokens=10).numpy(), ref)
    jeng = deepspeed_tpu.init_inference(hf, dtype="float32")
    np.testing.assert_array_equal(np.asarray(jeng.generate(prompts, max_new_tokens=10)), ref)
    assert len(set(ref[0, 9:].tolist())) > 1, "degenerate stream tests nothing"
    assert_close(eng(prompts).numpy(), np.asarray(jeng(prompts)))


@pytest.mark.parametrize("name", sorted(STANDINS))
def test_standin_has_a_transformers_models_layout(name):
    transformers = pytest.importorskip("transformers")
    model, hf = standin(name)
    hc = hf.config
    if name == "gptj-6b":
        real = transformers.GPTJForCausalLM(transformers.GPTJConfig(
            vocab_size=hc.vocab_size, n_positions=hc.n_positions, n_embd=hc.n_embd,
            n_layer=hc.n_layer, n_head=hc.n_head, rotary_dim=hc.rotary_dim,
            activation_function=hc.activation_function, tie_word_embeddings=False))
    else:
        real = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
            vocab_size=hc.vocab_size, max_position_embeddings=hc.max_position_embeddings,
            hidden_size=hc.hidden_size, num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads, rotary_pct=hc.rotary_pct,
            intermediate_size=hc.intermediate_size, hidden_act=hc.hidden_act,
            use_parallel_residual=hc.use_parallel_residual, tie_word_embeddings=False))
    want = {k: tuple(v.shape) for k, v in real.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    assert got == want
    # the real model holding the stand-in's weights computes the port's logits
    real.load_state_dict(hf.state_dict())
    ids = torch.from_numpy(np.random.default_rng(5).integers(1, 300, size=(1, 16)))
    with torch.no_grad():
        ref = real(ids).logits.float().numpy()
    port = model.forward_logits(ids).numpy()[..., :300]
    np.testing.assert_allclose(port, ref, atol=3e-4 * max(1.0, np.abs(ref).max()), rtol=0)
