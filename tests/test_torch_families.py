"""Parity of the port's LLaMA-style and BLOOM families
(``deepspeed_tpu_torch/models/gpt.py``, ``models/convert.py``,
``ops/cuda/decode_attention.py``'s plain versions, ``serving/``) with
``deepspeed_tpu/models/gpt.py`` and ``deepspeed_tpu/serving/`` on the CPU.

Inputs are made with numpy from a seed and fed to both packages; weights
come from the JAX init (matrices scaled up so greedy streams vary) and
reach the port through ``params_from_jax``.  Tolerances, fp32: the largest
difference of outputs and logits within 1e-5 of max(1, the reference's
largest magnitude) (both sides sum in fp32, in different orders); greedy
tokens identical.

The tiny models keep the served widths' head_dims (128 for LLaMA and
BLOOM, 256 for GPT-J, 96 for GPT-NeoX-20B) so the shapes the kernels take
on the card are the ones held here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import gpt_from_jax, params_from_jax
from deepspeed_tpu_torch.ops.attention import alibi_slopes
from deepspeed_tpu_torch.ops.cuda import decode_attention as tda
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from deepspeed_tpu_torch.serving.kv_cache import PagedKVAllocator

TOL = 1e-5

# the two full-size configurations served on the card (chip_smoke.py)
FULL_SIZE = {
    # meta-llama/Meta-Llama-3-8B config.json
    "llama3-8b": ("llama", dict(vocab_size=128256, n_positions=8192, n_embd=4096,
                                n_layer=32, n_head=32, n_kv_head=8,
                                intermediate_size=14336, rope_theta=500000.0,
                                ln_eps=1e-5)),
    # bigscience/bloom-7b1 config.json
    "bloom-7b1": ("bloom", dict(vocab_size=250880, n_positions=2048, n_embd=4096,
                                n_layer=30, n_head=32)),
}

# tiny models of each family and topology, fp32
TINY = {
    # LLaMA at head_dim 128, GQA 1:2
    "llama-g2": ("llama", dict(vocab_size=300, n_positions=96, n_embd=256, n_layer=2,
                               n_head=2, n_kv_head=1, intermediate_size=320,
                               rope_theta=500000.0)),
    # LLaMA at head_dim 128, GQA 1:4 (Llama-3-8B's group)
    "llama-g4": ("llama", dict(vocab_size=300, n_positions=96, n_embd=512, n_layer=2,
                               n_head=4, n_kv_head=1, intermediate_size=384)),
    # BLOOM: ALiBi, tied head, gelu MLP, head_dim 128
    "bloom": ("bloom", dict(vocab_size=300, n_positions=96, n_embd=256, n_layer=2,
                            n_head=2)),
    # GPT-NeoX-style: parallel residual, partial rope, GQA, relu MLP
    "neox-parallel": ("gpt", dict(vocab_size=300, n_positions=96, n_embd=128, n_layer=2,
                                  n_head=4, n_kv_head=2, position_encoding="rope",
                                  rope_dim=16, block_type="parallel", activation="relu")),
    # GPT-J-style: one norm feeds both, interleaved partial rope, untied
    # head with a bias, exact gelu
    "gptj-single-ln": ("gpt", dict(vocab_size=300, n_positions=96, n_embd=128, n_layer=2,
                                   n_head=4, position_encoding="rope", rope_dim=16,
                                   rope_interleaved=True, block_type="parallel_single_ln",
                                   untied_head=True, head_bias=True, activation="gelu")),
    # GPT-J-6B's topology at its head_dim 256: interleaved rope over 64
    # features, one norm, an untied head with a bias, tanh gelu
    "gptj-d256": ("gpt", dict(vocab_size=300, n_positions=96, n_embd=512, n_layer=2,
                              n_head=2, position_encoding="rope", rope_dim=64,
                              rope_interleaved=True, block_type="parallel_single_ln",
                              untied_head=True, head_bias=True)),
    # GPT-NeoX-20B's at its head_dim 96: half-split rope over 24 features, a
    # parallel residual, an untied head
    "neox-d96": ("gpt", dict(vocab_size=300, n_positions=96, n_embd=192, n_layer=2,
                             n_head=2, position_encoding="rope", rope_dim=24,
                             block_type="parallel", intermediate_size=384, untied_head=True)),
}


def make_config(pkg, family, kw, **extra):
    ctor = {"llama": pkg.llama_config, "bloom": pkg.bloom_config,
            "gpt": pkg.GPTConfig}[family]
    return ctor(**kw, **extra)


def jax_model(name, seed=0, scale=2.0):
    """JAX config + params (matrices scaled by ``scale``; biases and the
    head bias made nonzero so their paths count) as numpy."""
    family, kw = TINY[name]
    cfg = make_config(jgpt, family, kw, dtype="float32")
    params = jgpt.GPT(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def scaled(path, a):
        a = np.asarray(a)
        if np.ndim(a) >= 2 and not path[-1].key.endswith("_b"):
            return a * scale
        if path[-1].key.endswith("_b") or path[-1].key == "lm_head_b":
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return cfg, jax.tree_util.tree_map_with_path(scaled, params)


def port_model(name, tree):
    family, kw = TINY[name]
    return gpt_from_jax(make_config(tgpt, family, kw, dtype="float32"), tree, device="cpu")


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"max-abs error over max(1, |ref|) {err:.3e} > {tol}"


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(FULL_SIZE))
def test_full_size_config_attributes_match_jax(name):
    family, kw = FULL_SIZE[name]
    t, j = make_config(tgpt, family, kw), make_config(jgpt, family, kw)
    for attr in ("qkv_dim", "ffn_dim", "kv_heads", "head_dim", "padded_vocab",
                 "position_encoding", "norm", "mlp_type", "use_bias", "untied_head",
                 "rope_theta", "block_type", "activation", "ln_eps"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert tgpt.count_params(t) == jgpt.GPT(j).num_params()
    assert t.head_dim == 128


# the GPT-J and GPT-NeoX families' full-size configurations chip_smoke.py
# serves (phases 22-23): parameters, head_dim and KV bytes a token in bf16
SERVED_FULL_SIZE = {"gptj-6b": (6_051_782_656, 256, 458_752),
                    "neox-20b": (20_554_567_680, 96, 1_081_344)}


@pytest.mark.parametrize("name", sorted(SERVED_FULL_SIZE))
def test_served_full_size_configs_match_jax(name):
    import chip_smoke
    ctor, kw, fp32_layers = chip_smoke.FAMILY_CELLS[name]
    t, j = getattr(tgpt, ctor)(**kw), getattr(jgpt, ctor)(**kw)
    for attr in ("qkv_dim", "ffn_dim", "kv_heads", "head_dim", "padded_vocab",
                 "position_encoding", "norm", "mlp_type", "use_bias", "untied_head",
                 "head_bias", "rope_dim", "rope_interleaved", "rope_theta", "block_type",
                 "activation", "ln_eps"):
        assert getattr(t, attr) == getattr(j, attr), attr
    params, head_dim, kv_bytes = SERVED_FULL_SIZE[name]
    assert tgpt.count_params(t) == jgpt.GPT(j).num_params() == params
    assert t.head_dim == head_dim and head_dim in tda.KERNEL_HEAD_DIMS
    assert 2 * t.n_layer * t.kv_heads * t.head_dim * 2 == kv_bytes
    assert fp32_layers < t.n_layer


def test_llama3_8b_sizes():
    t = make_config(tgpt, *FULL_SIZE["llama3-8b"])
    assert tgpt.count_params(t) == 8_030_261_248 + 1_642_496
    assert (t.kv_heads, t.qkv_dim, t.padded_vocab) == (8, 6144, 128256)
    # K and V of 32 layers x 8 kv heads x 128 in bf16: the arena's bytes a token
    assert 2 * t.n_layer * t.kv_heads * t.head_dim * 2 == 131_072


@pytest.mark.parametrize("knob,value", [
    ("position_encoding", "sinusoid"), ("norm", "batchnorm"), ("mlp_type", "geglu"),
    ("block_type", "moe"), ("activation", "tanh"), ("n_kv_head", 3),
    ("head_bias", True),
])
def test_config_rejects_values_jax_does_not_define(knob, value):
    with pytest.raises(ValueError):
        tgpt.GPTConfig(vocab_size=64, n_embd=64, n_layer=1, n_head=4, **{knob: value})


# --------------------------------------------------------------------------- #
# pieces
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("rope_dim", [None, 16])
@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rope_matches_jax(interleaved, rope_dim, per_row, theta):
    rng = np.random.default_rng(7)
    B, S, H, D = 3, 11, 4, 32
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    if per_row:
        pos = (rng.integers(0, 8000, size=(B, 1)) + np.arange(S)[None]).astype(np.int32)
    else:
        pos = (4000 + np.arange(S)).astype(np.int32)
    j = jgpt.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, rope_dim, interleaved)
    t = tgpt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, rope_dim,
                        interleaved)
    assert_close(t.numpy(), j)
    if rope_dim:
        np.testing.assert_array_equal(t.numpy()[..., rope_dim:], x[..., rope_dim:])


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm_matches_jax(eps):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    j = jgpt.rms_norm(jnp.asarray(x), jnp.asarray(g), eps)
    t = tgpt.rms_norm(torch.from_numpy(x), torch.from_numpy(g), eps)
    assert_close(t.numpy(), j)
    bf = tgpt.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g), eps)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("mlp_type,activation,use_bias", [
    ("swiglu", "gelu", False), ("swiglu", "gelu", True), ("standard", "gelu", True),
    ("standard", "relu", False), ("standard", "gelu_tanh", True),
    ("standard", "gelu_quick", True),
])
def test_mlp_matches_jax(mlp_type, activation, use_bias):
    kw = dict(vocab_size=64, n_embd=32, n_layer=1, n_head=4, mlp_type=mlp_type,
              activation=activation, use_bias=use_bias, intermediate_size=48,
              dtype="float32")
    jcfg, tcfg = jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)
    rng = np.random.default_rng(5)
    F_ = tgpt.fc_width(tcfg)
    p = {"fc_w": rng.standard_normal((32, F_)), "fc_b": rng.standard_normal(F_),
         "proj_w": rng.standard_normal((48, 32)) / 4, "proj_b": rng.standard_normal(32)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    h = rng.standard_normal((2, 3, 32)).astype(np.float32)
    j = jgpt._mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h),
                  jnp.float32)
    t = tgpt._mlp(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(h), torch.float32)
    assert_close(t.numpy(), j)


def test_alibi_slopes_match_jax():
    for H in (1, 2, 8, 12, 25, 32, 112):
        np.testing.assert_array_equal(alibi_slopes(H), jax_alibi_slopes(H))


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("name", ["llama-g2", "bloom", "gptj-single-ln"])
def test_params_from_jax_key_sets(name, scan_layers):
    """Every leaf of a family's JAX tree arrives with the port's key and
    shape: no ``wpe`` for rope and ALiBi, ``lm_head`` (and its bias) when
    untied, the GQA qkv and SwiGLU gate | up widths, zero bias leaves."""
    family, kw = TINY[name]
    jcfg = make_config(jgpt, family, kw, dtype="float32", scan_layers=scan_layers)
    tree = jax.tree.map(np.asarray, jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    sd = params_from_jax(tree)
    tcfg = make_config(tgpt, family, kw, dtype="float32")
    top, block = tgpt.leaf_shapes(tcfg)
    expected = set(top) | {f"blocks.{i}.{k}" for i in range(tcfg.n_layer) for k in block}
    assert set(sd) == expected
    assert set(top) == set(tree) - {"blocks"}
    for k, shape in top.items():
        assert tuple(sd[k].shape) == shape, k
        np.testing.assert_array_equal(sd[k].numpy(), tree[k])
    for k, shape in block.items():
        assert tuple(sd[f"blocks.1.{k}"].shape) == shape, k
    model = gpt_from_jax(tcfg, tree, device="cpu")
    assert model.num_params() == jgpt.GPT(jcfg).num_params()
    assert sorted(model.state_dict()) == sorted(sd)


@pytest.mark.parametrize("name", sorted(TINY))
def test_seeded_init_has_the_jax_tree(name):
    """The port's own seeded init makes JAX's keys and shapes, in fp32 or
    straight in bf16 (the fp32 values rounded, leaf by leaf)."""
    family, kw = TINY[name]
    jcfg = make_config(jgpt, family, kw, dtype="float32")
    jtree = jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = make_config(tgpt, family, kw, dtype="float32")
    m32 = tgpt.GPT(tcfg, device="cpu", seed=3)
    m16 = tgpt.GPT(tcfg, device="cpu", seed=3, param_dtype=torch.bfloat16)
    assert set(tgpt.top_keys(tcfg)) == set(jtree) - {"blocks"}
    for (k, a), (k2, b) in zip(m32.state_dict().items(), m16.state_dict().items()):
        assert k == k2 and b.dtype == torch.bfloat16
        assert torch.equal(a.bfloat16(), b), k
    assert m32.state_dict()["blocks.0.qkv_w"].shape == jtree["blocks"]["qkv_w"].shape[1:]
    assert m32.state_dict()["blocks.0.fc_w"].shape == jtree["blocks"]["fc_w"].shape[1:]


# --------------------------------------------------------------------------- #
# attention plain versions: GQA and ALiBi
# --------------------------------------------------------------------------- #
ATTN_CASES = {
    # name: (H, Hkv, alibi, S_q, pos or lengths)
    "g1-decode": (4, 4, False, 1, (20, 15)),
    "g2-alibi-decode": (4, 2, True, 1, (31, 0)),
    "g4-alibi-chunk": (8, 2, True, 5, (9, 40)),
    "g8-chunk": (8, 1, False, 6, (0, 17)),
    "g1-alibi-prefill": (2, 2, True, 12, (0, 0)),
}


def attn_inputs(case, T=64, D=16, seed=11):
    H, Hkv, alibi, Sq, lengths = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    kv = [rng.standard_normal((2, T, Hkv, D)).astype(np.float32) for _ in range(2)]
    return q, kv[0], kv[1], np.asarray(lengths, np.int32), alibi_slopes(H) if alibi else None


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_contiguous_plain_matches_jax_cached_attention(case):
    q, ck, cv, lengths, slopes = attn_inputs(case)
    pos = int(lengths[0])
    Sq, T = q.shape[1], ck.shape[1]
    bias = None
    if slopes is not None:
        dist = np.arange(T)[None, :] - (pos + np.arange(Sq))[:, None]
        bias = jnp.asarray((slopes[:, None, None] * dist.astype(np.float32))[None])
    j = jgpt._cached_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                               jnp.int32(pos), bias=bias)
    t = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
                             pos, alibi=None if slopes is None else torch.from_numpy(slopes))
    assert_close(t.numpy(), j)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_paged_plain_matches_jax_reference(case):
    """Through shuffled block tables; JAX gets ALiBi as the ``[B, H, S_q,
    T]`` bias its serving step builds, the port as slopes."""
    q, ck, cv, lengths, slopes = attn_inputs(case)
    B, Sq, H, D = q.shape
    T, Hkv, BS = ck.shape[1], ck.shape[2], 8
    MB = T // BS
    rng = np.random.default_rng(1)
    ids = rng.permutation(np.arange(1, B * MB + 1)).astype(np.int32).reshape(B, MB)
    kp = np.zeros((B * MB + 1, BS, Hkv, D), np.float32)
    vp = np.zeros_like(kp)
    kp[ids] = ck.reshape(B, MB, BS, Hkv, D)
    vp[ids] = cv.reshape(B, MB, BS, Hkv, D)
    bias = None
    if slopes is not None:
        qpos = lengths[:, None] + np.arange(Sq)[None]
        dist = (np.arange(T)[None, None, :] - qpos[:, :, None]).astype(np.float32)
        bias = jnp.asarray(slopes[None, :, None, None] * dist[:, None])
    j = jda.paged_attention_reference(*map(jnp.asarray, (q, kp, vp, ids, lengths)),
                                      bias=bias)
    args = [torch.from_numpy(a) for a in (q, kp, vp, ids, lengths)]
    t = tda.paged_attention(*args, alibi=None if slopes is None else torch.from_numpy(slopes))
    assert_close(t.numpy(), j)
    if bias is not None:        # the bias= argument keeps its plain-version meaning
        tb = tda.paged_attention(*args, bias=torch.tensor(np.asarray(bias)))
        assert_close(tb.numpy(), j)


# --------------------------------------------------------------------------- #
# the model: paged step, generate(), the serving engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(TINY))
def test_paged_step_logits_match_jax(name):
    """A padded prefill chunk for one row, then a decode step of two rows
    (one idle), through the same allocator tables and write maps."""
    jcfg, tree = jax_model(name, seed=2)
    model = port_model(name, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = model.cfg
    BS, NB, MB, C = 8, 16, 6, 16
    alloc = PagedKVAllocator(NB, BS, MB)
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, cfg.vocab_size, size=11).astype(np.int32)
    alloc.allocate("a", 12)
    shape = (cfg.n_layer, NB, BS, cfg.kv_heads, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    ids = np.zeros((1, C), np.int32)
    ids[0, :11] = prompt
    wb, wo = alloc.write_map("a", 0, C, n_valid=11)
    table = alloc.block_table("a")[None]
    step_in = [ids, np.asarray([0], np.int32), table, wb[None], wo[None]]
    jl, jk, jv = jgpt.gpt_paged_step(jcfg, jparams, *map(jnp.asarray, step_in[:2]), jk, jv,
                                     *map(jnp.asarray, step_in[2:]))
    tl, tk, tv = model.paged_step(*map(torch.from_numpy, step_in[:2]), tk, tv,
                                  *map(torch.from_numpy, step_in[2:]))
    assert_close(tl.numpy()[0, :11], np.asarray(jl)[0, :11])
    # decode: row 0 idle (trash), row 1 the sequence at position 11
    tok = int(np.argmax(np.asarray(jl)[0, 10, :cfg.vocab_size]))
    ids = np.asarray([[0], [tok]], np.int32)
    tables = np.zeros((2, MB), np.int32)
    tables[1] = alloc.block_table("a")
    wb, wo = np.zeros((2, 1), np.int32), np.zeros((2, 1), np.int32)
    wb[1], wo[1] = alloc.write_map("a", 11, 1)
    step_in = [ids, np.asarray([0, 11], np.int32), tables, wb, wo]
    jl, jk, jv = jgpt.gpt_paged_step(jcfg, jparams, *map(jnp.asarray, step_in[:2]), jk, jv,
                                     *map(jnp.asarray, step_in[2:]))
    tl, tk, tv = model.paged_step(*map(torch.from_numpy, step_in[:2]), tk, tv,
                                  *map(torch.from_numpy, step_in[2:]))
    assert_close(tl.numpy()[1], np.asarray(jl)[1])
    for layer in range(cfg.n_layer):        # the live arena blocks
        for b in alloc.block_table("a")[:2]:
            assert_close(tk[layer, b].numpy(), np.asarray(jk)[layer, b])
            assert_close(tv[layer, b].numpy(), np.asarray(jv)[layer, b])


@pytest.mark.parametrize("name", sorted(TINY))
def test_apply_with_cache_logits_match_jax(name):
    """Prefill then two decode steps through the contiguous cache."""
    jcfg, tree = jax_model(name, seed=1)
    model = port_model(name, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    B, S, T = 2, 9, 16
    ids = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jcache = jgpt.init_kv_cache(jcfg, B, T)
    tcache = model.init_cache(B, T)
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
    for step in range(3):
        jl, jcache = jgpt.gpt_apply_with_cache(jcfg, jparams, jnp.asarray(ids), jcache)
        tl, tcache = model.apply_with_cache(torch.from_numpy(ids), tcache)
        assert_close(tl.numpy(), np.asarray(jl))
        ids = np.asarray(jnp.argmax(jl[:, -1:, :jcfg.vocab_size], axis=-1)).astype(np.int32)
    assert_close(tcache["k"].numpy(), np.asarray(jcache["k"]))


@pytest.mark.parametrize("name", sorted(TINY))
def test_generate_tokens_identical(name):
    jcfg, tree = jax_model(name, seed=3)
    model = port_model(name, tree)
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jout = np.asarray(jgpt.GPT(jcfg).generate(jax.tree.map(jnp.asarray, tree),
                                              jnp.asarray(prompts), 12))
    tout = model.generate(prompts, 12).numpy()
    np.testing.assert_array_equal(tout, jout)
    assert len(set(tout[0, 9:].tolist())) > 1, "degenerate stream tests nothing"


def test_serving_engine_arena_holds_kv_heads():
    """The GQA arena holds Hkv heads: half the bytes of an MHA arena here."""
    model = tgpt.GPT(make_config(tgpt, *TINY["llama-g2"], dtype="float32"), device="cpu")
    eng = dst.init_serving(model=model, device="cpu", config={"serving": dict(
        block_size=8, num_blocks=16, max_batch_size=2, prefill_chunk=8, dtype="float32")})
    assert tuple(eng._k_pages.shape) == (2, 16, 8, 1, 128)
    assert eng.module is model


@pytest.mark.parametrize("name", ["llama-g2", "bloom", "neox-parallel"])
def test_training_takes_the_families(name):
    """gpt_forward, the model's loss and initialize() -> train_batch take
    the families (they raised before training was ported for them): the
    logits and the loss match JAX's, and a train_batch step gives a finite
    loss (the full parity of training is tests/test_torch_family_training.py)."""
    jcfg, jparams = jax_model(name)
    model = port_model(name, jparams)
    cfg = model.cfg
    rng = np.random.default_rng(31)
    ids = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.roll(ids, -1, axis=-1)
    want = jgpt.gpt_forward(jcfg, jparams, jnp.asarray(ids))
    got = tgpt.gpt_forward(cfg, model.param_tree(), torch.from_numpy(ids))
    assert_close(got.numpy(), np.asarray(want))
    jloss = float(jgpt.gpt_loss(jcfg, jparams, jnp.asarray(ids), jnp.asarray(labels)))
    loss = float(model(model.param_tree(), (torch.from_numpy(ids), torch.from_numpy(labels))))
    assert abs(loss - jloss) <= TOL * abs(jloss)
    engine = dst.initialize(model=model, device="cpu", model_parameters=params_from_jax(jparams),
                            config={"train_micro_batch_size_per_gpu": 2,
                                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})[0]
    step = float(engine.train_batch(batch=(ids[None], labels[None])))
    assert np.isfinite(step) and abs(step - jloss) <= TOL * abs(jloss)
    assert tgpt.GPT(dataclasses.replace(cfg, n_layer=1), device="cpu").num_params() > 0


@pytest.mark.parametrize("what", ["pld_theta", "dropout", "head_dim-96-on-the-card",
                                  "initialize-at-head_dim-256-on-the-card"])
def test_training_refuses_the_families(what, monkeypatch):
    """What training still leaves unported raises NotImplementedError naming
    its ROADMAP entry: progressive layer drop, dropout, and a head_dim the
    flash backward kernels are not compiled for (the card's kernels; shapes
    are checked before the device, so meta tensors meet the same check),
    in the wrapper and in ``initialize()`` on the card.  GPT-NeoX-20B's
    head_dim 96 and GPT-J's 256 pass both checks; 80 and 512 stand for
    the widths still refused."""
    family, kw = TINY["llama-g2"]
    if what == "pld_theta":
        model = tgpt.GPT(make_config(tgpt, family, kw, dtype="float32"), device="cpu")
        ids = torch.zeros(1, 4, dtype=torch.long)
        with pytest.raises(NotImplementedError, match="progressive layer drop.*ROADMAP"):
            model(model.param_tree(), (ids, ids), pld_theta=0.5)
    elif what == "dropout":
        cfg = make_config(tgpt, family, kw, dtype="float32", dropout=0.1)
        model = tgpt.GPT(cfg, device="cpu")
        ids = torch.zeros(1, 4, dtype=torch.long)
        with pytest.raises(NotImplementedError, match="dropout"):
            model(model.param_tree(), (ids, ids))
    elif what.startswith("initialize"):
        # the engine checks the model's head_dim before it touches the card:
        # GPT-J's topology at twice its width (head_dim 512) is refused
        from deepspeed_tpu_torch.runtime import engine as engine_mod
        family_j, kw_j = TINY["gptj-d256"]
        assert tgpt.GPT(make_config(tgpt, family_j, kw_j, dtype="float32"),
                        device="cpu").cfg.head_dim == 256
        tfa.check_head_dim("initialize()", 256, backward=True)      # GPT-J's own passes
        model = tgpt.GPT(make_config(tgpt, family_j, dict(kw_j, n_embd=1024), dtype="float32"),
                         device="cpu")
        monkeypatch.setattr(engine_mod, "resolve_device", lambda device=None: torch.device("cuda"))
        with pytest.raises(NotImplementedError,
                           match="initialize.*head_dim 64, 96, 128, 256, got 512.*Queue 2 part A"):
            dst.initialize(model=model, config={"train_micro_batch_size_per_gpu": 1,
                                                "optimizer": {"type": "AdamW",
                                                              "params": {"lr": 1e-3}}})
    else:
        stat = torch.empty(1, 2, 300, device="meta")
        q = torch.empty(1, 300, 2, 96, device="meta")
        tfa.check_head_dim("flash_backward_dq", 96, backward=True)    # NeoX-20B's passes
        with pytest.raises(ValueError, match="no kernel"):           # past the head_dim check
            tfa.flash_backward_dq(q, q, q, q, stat, stat, None, None, True, 96 ** -0.5)
        q = torch.empty(1, 300, 2, 80, device="meta")
        with pytest.raises(NotImplementedError,
                           match="head_dim 64, 96, 128, 256, got 80.*Queue 2 part A"):
            tfa.flash_backward_dq(q, q, q, q, stat, stat, None, None, True, 80 ** -0.5)
