"""Parity of the port's GPT (``deepspeed_tpu_torch/models/gpt.py`` and
``models/convert.py``) with ``deepspeed_tpu/models/gpt.py`` on the CPU.

Weights come from the JAX init (scaled up so greedy streams are not
constant) and reach the port through ``params_from_jax``.  Inputs are made
with numpy.  Tolerances, fp32: logits within 1e-4 absolute (both sides sum
in fp32 in different orders through a few layers); K/V caches within 1e-5
of their largest magnitude; greedy tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import gpt_from_jax, params_from_jax
from deepspeed_tpu_torch.serving.kv_cache import PagedKVAllocator

LOGIT_ATOL = 1e-4

CONFIGS = {
    "tiny": dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2,
                 n_head=4),
    "narrow-25-heads": dict(vocab_size=300, n_positions=64, n_embd=200,
                            n_layer=2, n_head=25),
}


def jax_model(name, seed=0, scale=4.0, **cfg_kw):
    """JAX config + params (matrices scaled by ``scale``) as numpy."""
    cfg = jgpt.GPTConfig(dtype="float32", **CONFIGS[name], **cfg_kw)
    params = jgpt.GPT(cfg).init_params(jax.random.PRNGKey(seed))
    return cfg, jax.tree.map(
        lambda a: np.asarray(a) * (scale if np.ndim(a) >= 2 else 1.0), params)


def assert_cache_close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def port_model(name, tree):
    cfg = tgpt.GPTConfig(dtype="float32", **CONFIGS[name])
    return gpt_from_jax(cfg, tree, device="cpu")


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_from_jax_round_trip(scan_layers):
    """Every JAX leaf (per layer, for the stacked layout) arrives exactly,
    in the [in, out] layout, and nothing is left over."""
    cfg, tree = jax_model("tiny", scale=1.0, scan_layers=scan_layers)
    sd = params_from_jax(tree)
    L = cfg.n_layer
    top = tgpt.top_keys(tgpt.GPTConfig(dtype="float32", **CONFIGS["tiny"]))
    assert top == ("wte", "wpe", "lnf_g", "lnf_b")
    for name in top:
        np.testing.assert_array_equal(sd[name].numpy(), tree[name])
    for i in range(L):
        layer = (jax.tree.map(lambda a: a[i], tree["blocks"]) if scan_layers
                 else tree["blocks"][f"h{i}"])
        for k in tgpt.BLOCK_KEYS:
            np.testing.assert_array_equal(sd[f"blocks.{i}.{k}"].numpy(), layer[k])
    assert len(sd) == len(top) + L * len(tgpt.BLOCK_KEYS)
    model = port_model("tiny", tree)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert model.num_params() == jgpt.GPT(cfg).num_params()


def test_params_from_jax_rejects_unported_leaves():
    """A dict leaf that is not an int8 weight is refused (int8 leaves,
    ``{"q8", "scale"}``, are taken: ``tests/test_torch_module_inject.py``
    holds them against JAX's); an untied head is taken (the families'
    tests hold it), a leaf no family has is refused, and an MoE tree
    converts (its nested ``moe`` leaves by dotted path, stacked per layer;
    ``tests/test_torch_moe.py`` holds the values)."""
    _, tree = jax_model("tiny")
    assert "lm_head" in params_from_jax(dict(tree, lm_head=tree["wte"]))
    with pytest.raises(ValueError, match="unknown"):
        params_from_jax(dict(tree, head=tree["wte"]))
    blocks = dict(tree["blocks"], qkv_w={"q": 1, "scale": 2})
    with pytest.raises(ValueError, match="neither an int8 weight"):
        params_from_jax(dict(tree, blocks=blocks))
    q8 = np.zeros(np.shape(tree["blocks"]["qkv_w"]), np.int8)
    scale = np.ones(q8.shape[:-2] + (1, q8.shape[-1]), np.float32)
    sd = params_from_jax(dict(tree, blocks=dict(tree["blocks"], qkv_w={"q8": q8,
                                                                       "scale": scale})))
    assert sd["blocks.1.qkv_w.q8"].dtype == torch.int8 and "blocks.1.qkv_w" not in sd
    assert tuple(sd["blocks.1.qkv_w.scale"].shape) == scale.shape[1:]
    cfg, moe_tree = jax_model("tiny", moe_num_experts=4, moe_expert_hidden=48)
    sd = params_from_jax(moe_tree)
    assert tuple(sd["blocks.1.moe.experts.wi"].shape) == (4, 32, 48)
    assert tuple(sd["blocks.0.moe.gate.wg"].shape) == (32, 4)
    assert "blocks.0.fc_w" not in sd
    model = gpt_from_jax(tgpt.GPTConfig(dtype="float32", **CONFIGS["tiny"], moe_num_experts=4,
                                        moe_expert_hidden=48), moe_tree, device="cpu")
    assert model.num_params() == jgpt.GPT(cfg).num_params()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_with_cache_logits_match(name):
    """Prefill then two decode steps through the contiguous cache."""
    jcfg, tree = jax_model(name, seed=1)
    model = port_model(name, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    B, S, T = 2, 11, 20
    ids = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jcache = jgpt.init_kv_cache(jcfg, B, T)
    tcache = model.init_cache(B, T)
    for step in range(3):
        jl, jcache = jgpt.gpt_apply_with_cache(jcfg, jparams, jnp.asarray(ids),
                                               jcache)
        tl, tcache = model.apply_with_cache(torch.from_numpy(ids), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=f"step {step}")
        assert tcache["pos"] == int(jcache["pos"])
        ids = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    assert_cache_close(tcache["k"], jcache["k"])
    assert_cache_close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_step_logits_and_arena_match(name):
    """A padded prefill chunk for one row, then a decode step with an idle
    slot, through the same allocator tables and write maps on both sides."""
    jcfg, tree = jax_model(name, seed=2)
    model = port_model(name, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    BS, NB, C = 4, 24, 8
    alloc = PagedKVAllocator(NB, BS, jcfg.n_positions // BS)
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, jcfg.vocab_size, size=13).astype(np.int32)
    alloc.allocate("a", len(prompt) + 1)
    shape = (jcfg.n_layer, NB, BS, jcfg.kv_heads, jcfg.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)

    def run(ids, positions, tables, wb, wo):
        nonlocal jk, jv
        jl, jk, jv = jgpt.gpt_paged_step(
            jcfg, jparams, *map(jnp.asarray, (ids, positions)), jk, jv,
            *map(jnp.asarray, (tables, wb, wo)))
        tl, _, _ = model.paged_step(*map(torch.from_numpy, (ids, positions)),
                                    tk, tv, *map(torch.from_numpy,
                                                 (tables, wb, wo)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        assert_cache_close(tk, jk)
        assert_cache_close(tv, jv)
        return np.asarray(jl)

    tables = alloc.block_table("a")[None]
    for start in range(0, len(prompt), C):            # chunks 8 + 5 (padded)
        n = min(C, len(prompt) - start)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = prompt[start:start + n]
        wb, wo = alloc.write_map("a", start, C, n_valid=n)
        logits = run(ids, np.asarray([start], np.int32), tables, wb[None], wo[None])
    tok = int(np.argmax(logits[0, n - 1, :jcfg.vocab_size]))
    # decode: slot 0 idle (trash table, length 0), slot 1 holds the request
    ids = np.asarray([[0], [tok]], np.int32)
    positions = np.asarray([0, len(prompt)], np.int32)
    tables2 = np.concatenate([np.zeros_like(tables), tables])
    wb, wo = alloc.write_map("a", len(prompt), 1)
    run(ids, positions, tables2, np.stack([[0], wb]).astype(np.int32),
        np.stack([[0], wo]).astype(np.int32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_tokens_identical(name):
    jcfg, tree = jax_model(name, seed=3)
    model = port_model(name, tree)
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jout = np.asarray(jgpt.GPT(jcfg).generate(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(prompts), 12))
    tout = model.generate(prompts, 12).numpy()
    np.testing.assert_array_equal(tout, jout)
    assert len(set(tout[0, 9:].tolist())) > 1, "degenerate stream tests nothing"


def test_padded_vocab_never_sampled():
    """Greedy decoding masks the padded vocab columns, as JAX's sampler."""
    cfg = tgpt.GPTConfig(dtype="float32", **CONFIGS["tiny"])
    assert cfg.padded_vocab == 384 and cfg.vocab_size == 300
    logits = torch.zeros(2, cfg.padded_vocab)
    logits[:, 350] = 10.0
    logits[:, 7] = 1.0
    assert tgpt.greedy_tokens(cfg, logits).tolist() == [7, 7]


@pytest.mark.parametrize("knob,value", [
    ("ltd_layers", (0,)), ("ltd_keep", 8), ("activation_quant_bits", 8),
])
def test_unported_config_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgpt.GPTConfig(**CONFIGS["tiny"], **{knob: value})


def test_gpt2_xl_preset_matches_jax():
    t, j = tgpt.gpt_config("gpt2-xl"), jgpt.gpt_config("gpt2-xl")
    for attr in ("n_layer", "n_embd", "n_head", "head_dim", "vocab_size",
                 "padded_vocab", "qkv_dim", "ffn_dim"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.n_layer, t.n_embd, t.n_head, t.head_dim, t.padded_vocab) == (
        48, 1600, 25, 64, 50304)
    assert t.dtype == torch.bfloat16


def test_seeded_init_distributions():
    """Same distributions as the JAX init (not the same numbers)."""
    cfg = tgpt.gpt_config("tiny", n_layer=8, dtype="float32")
    m = tgpt.GPT(cfg, device="cpu", seed=5)
    assert torch.equal(m.wte, tgpt.GPT(cfg, device="cpu", seed=5).wte)
    assert abs(m.wte.std().item() - 0.02) < 2e-3
    assert abs(m.wpe.std().item() - 0.01) < 1e-3
    proj = torch.stack([b.proj_w for b in m.blocks])
    assert abs(proj.std().item() - 0.02 / np.sqrt(2 * cfg.n_layer)) < 5e-4
    assert torch.all(m.blocks[0].ln1_g == 1) and torch.all(m.blocks[0].qkv_b == 0)
