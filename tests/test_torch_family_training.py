"""Training the LLaMA, BLOOM, GPT-NeoX-style and GPT-J-style families in the
port (``deepspeed_tpu_torch/models/gpt.py``, ``runtime/engine.py``), against
the JAX package on the CPU.

* ``gpt_loss`` and every gradient against ``jax.value_and_grad`` of JAX's
  ``gpt_loss`` (fp32, remat on and off) for tiny configs of each family:
  LLaMA at head_dim 128 with GQA 2:1 and 4:1 and an untied head, BLOOM
  (ALiBi slopes, tied head), a GPT-NeoX-style parallel block (partial rope,
  GQA 2:1) and a GPT-J-style single-norm parallel block (interleaved
  partial rope, untied head with a bias), each at S 32 (the reference
  attention in both packages) and S 288 (above 256: the port's flash plain
  versions against what JAX runs for flash off the TPU).  Weights are JAX's
  init with the matrices doubled and the biases (the head bias among them)
  made nonzero, so every path counts.  Tolerance, as
  ``tests/test_torch_training.py``: the loss within 1e-5 relative, each
  gradient within 1e-4 of its largest magnitude (fp32 sums in other orders,
  through norms and a softmax).
* Remat keeps the flash op's o and lse for these blocks too (rope, RMSNorm
  and SwiGLU are recomputed): the flash forward runs once per layer.
* The engine: three ``train_batch`` steps of a tiny LLaMA, BLOOM and GPT-J
  (head bias) engine (AdamW, clip binding, GAS 2) against the JAX engine with both
  Pallas gates on (cross-entropy and fused Adam in interpret mode), from
  parameters carried across by ``models/convert.py``; the tolerances of
  ``test_engine_trajectory_matches_the_jax_engine``.
* A bitwise save / resume of a tiny LLaMA engine through
  ``runtime/checkpointing.py``.

Inputs come from a seed with numpy.  The file stands on its own so that
``--dist loadfile`` gives it a worker of its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import adam_state_from_jax, params_from_jax
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
N_POSITIONS = 320

# tiny models of each family, fp32 (family constructor, widths)
FAMILIES = {
    # LLaMA at head_dim 128, GQA 2:1, untied head
    "llama-g2": ("llama", dict(vocab_size=300, n_embd=256, n_layer=2, n_head=2, n_kv_head=1,
                               intermediate_size=320, rope_theta=500000.0)),
    # LLaMA at head_dim 128, GQA 4:1 (Llama-3-8B's group)
    "llama-g4": ("llama", dict(vocab_size=300, n_embd=512, n_layer=2, n_head=4, n_kv_head=1,
                               intermediate_size=384)),
    # BLOOM: ALiBi, tied head, gelu MLP, head_dim 128
    "bloom": ("bloom", dict(vocab_size=300, n_embd=256, n_layer=2, n_head=2)),
    # GPT-NeoX-style: parallel residual, partial rope, GQA 2:1, relu MLP
    "neox-parallel": ("gpt", dict(vocab_size=300, n_embd=128, n_layer=2, n_head=4, n_kv_head=2,
                                  position_encoding="rope", rope_dim=16, block_type="parallel",
                                  activation="relu")),
    # GPT-J-style: one norm feeds both, interleaved partial rope, untied
    # head with a bias, exact gelu
    "gptj-single-ln": ("gpt", dict(vocab_size=300, n_embd=128, n_layer=2, n_head=4,
                                   position_encoding="rope", rope_dim=16, rope_interleaved=True,
                                   block_type="parallel_single_ln", untied_head=True,
                                   head_bias=True, activation="gelu")),
}
SEQS = (32, 288)          # the reference attention; flash (above 256)


def make_config(pkg, name, **extra):
    family, kw = FAMILIES[name]
    ctor = {"llama": pkg.llama_config, "bloom": pkg.bloom_config, "gpt": pkg.GPTConfig}[family]
    return ctor(**dict(kw, n_positions=N_POSITIONS, **extra))


def jax_params(cfg, seed=0, scale=2.0):
    """JAX's init as numpy, matrices scaled by ``scale`` and biases (the
    head bias among them) made nonzero."""
    params = jgpt.GPT(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def scaled(path, a):
        a = np.asarray(a)
        if path[-1].key.endswith("_b"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a * scale if np.ndim(a) >= 2 else a
    return jax.tree_util.tree_map_with_path(scaled, params)


def batch(vocab, B, S, seed, gas=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S) if gas is None else (gas, B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=-1)


def port_model(name, tree, **extra):
    cfg = make_config(tgpt, name, dtype="float32", **extra)
    model = tgpt.GPT(cfg, device="cpu", state_dict=params_from_jax(tree))
    for p in model.parameters():
        p.requires_grad_(True)
    return cfg, model


# --------------------------------------------------------------------------- #
# gpt_loss and its gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gpt_loss_and_every_grad_match_jax(monkeypatch, name, S, remat):
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    B = 2 if S <= 256 else 1
    jcfg = make_config(jgpt, name, dtype="float32", remat=remat)
    jtree = jax_params(jcfg)
    ids, labels = batch(jcfg.vocab_size, B, S, seed=5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels)))(
        jax.tree.map(jnp.asarray, jtree))
    cfg, model = port_model(name, jtree, remat=remat)
    tfa.reset_counts()
    loss = tgpt.gpt_loss(cfg, model.param_tree(), torch.from_numpy(ids),
                         torch.from_numpy(labels))
    loss.backward()
    # above 256 tokens "auto" is flash (its plain versions here), at 32 the reference
    assert tfa.flash_forward_reference.calls == (cfg.n_layer if S > 256 else 0)
    tfa.reset_counts()
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = params_from_jax(jgrads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        # a leaf the family leaves out of its forward (a bias-free family's
        # biases, RMSNorm's shift, GPT-J's second norm) has no gradient
        # here and zeros in JAX
        grad = got[k].grad if got[k].grad is not None else torch.zeros_like(got[k])
        np.testing.assert_allclose(grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(g.abs().max()), err_msg=k)


@pytest.mark.parametrize("policy", ["saves flash o and lse", "nothing saveable"])
@pytest.mark.parametrize("name", ["llama-g4", "bloom"])
def test_remat_runs_the_flash_forward_once_per_layer(monkeypatch, name, policy):
    """JAX's checkpoint policy holds for these blocks: under remat a block
    keeps its input plus the flash op's o and lse and recomputes rope,
    RMSNorm, SwiGLU (or ALiBi's slopes and the gelu MLP), so one forward and
    backward runs the flash forward once per layer (twice when the policy
    saves nothing), dQ and dKV once."""
    if policy == "nothing saveable":
        monkeypatch.setattr(checkpointing, "SAVED_OPS", frozenset())
    cfg = make_config(tgpt, name, dtype="float32", remat=True, n_layer=3)
    model = tgpt.GPT(cfg, device="cpu", seed=3)
    for p in model.parameters():
        p.requires_grad_(True)
    ids, labels = batch(cfg.vocab_size, 1, 300, seed=10)
    tfa.reset_counts()
    loss = tgpt.gpt_loss(cfg, model.param_tree(), torch.from_numpy(ids),
                         torch.from_numpy(labels))
    assert tfa.flash_forward_reference.calls == cfg.n_layer
    loss.backward()
    L = cfg.n_layer
    forwards = L if policy == "saves flash o and lse" else 2 * L
    assert (tfa.flash_forward_reference.calls, tfa.flash_backward_dq_reference.calls,
            tfa.flash_backward_dkv_reference.calls) == (forwards, L, L)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    tfa.reset_counts()


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #
ENGINE_LR, CLIP, GAS, MICRO, SEQ, STEPS = 1e-3, 1.0, 2, 2, 16, 3


def engine_config():
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW", "params": {"lr": ENGINE_LR, "weight_decay": 0.01}},
            "gradient_clipping": CLIP, "steps_per_print": 10 ** 9}


def run_jax_engine(cfg, params, batches, config):
    mesh = mesh_lib.MeshSpec(device_count=1).build(jax.devices()[:1])
    try:
        engine, _, _, _ = deepspeed_tpu.initialize(
            model=jgpt.GPT(cfg), model_parameters=params, config=config, mesh=mesh)
        assert engine._fused_opt_active()
        losses, norms = [], []
        for ids, labels in batches:
            losses.append(float(engine.train_batch(batch=(ids, labels))))
            norms.append(engine.get_global_grad_norm())
        return losses, norms, engine.state.params, engine.state.opt_state
    finally:
        mesh_lib.reset_mesh()


@pytest.mark.parametrize("name", ["llama-g2", "bloom", "gptj-single-ln"])
def test_engine_trajectory_matches_the_jax_engine(monkeypatch, name):
    """Losses and grad norms within 1e-5 relative; moments within 1e-4 of
    their largest magnitude; final parameters within 2e-5 absolute, except
    where a step's gradient was at rounding level.  Adam moves an element by
    about lr whatever its gradient's size, so an element whose gradient at
    some step is within the gradients' tolerance (1e-4 of its leaf's
    largest, where the two packages' fp32 sums are not held to agree: the
    attention key bias, whose gradient is zero in exact arithmetic, or an
    MLP weight behind a saturated unit) is held only to Adam's bound, 2 * lr
    per step."""
    monkeypatch.setenv("DST_PALLAS_CE", "1")
    monkeypatch.setenv("DST_PALLAS_FUSED_OPT", "1")
    config = engine_config()
    jcfg = make_config(jgpt, name, dtype="float32", scan_layers=True)
    jtree = jax_params(jcfg)
    batches = [batch(jcfg.vocab_size, MICRO, SEQ, seed=20 + i, gas=GAS) for i in range(STEPS)]
    jlosses, jnorms, jfinal, jstate = run_jax_engine(jcfg, jtree, batches, config)

    model = tgpt.GPT(make_config(tgpt, name, dtype="float32"), device="cpu")
    engine, optimizer, _, _ = dst.initialize(model=model, config=config,
                                             model_parameters=params_from_jax(jtree),
                                             device="cpu")
    names = [k for k, _ in model.named_parameters()]
    losses, norms, rounding_level = [], [], None
    for ids, labels in batches:
        losses.append(float(engine.train_batch(batch=(ids, labels))))
        norms.append(engine.get_global_grad_norm())
        small = [(g.abs() <= GRAD_TOL * g.abs().max()).view_as(p)
                 for g, p in zip(engine._grads, model.parameters())]
        rounding_level = small if rounding_level is None else [
            a | b for a, b in zip(rounding_level, small)]
    assert min(jnorms) > CLIP and min(norms) > CLIP     # the clip binds every step
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-5)
    want = params_from_jax(jfinal)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, held in zip(names, rounding_level):
        diff = np.abs(got[k].detach().numpy() - want[k].numpy())
        assert diff.max() <= 2 * ENGINE_LR * STEPS, k
        rest = diff[~held.numpy()]
        assert rest.size == 0 or rest.max() <= 2e-5, (k, rest.max())
    jadam = adam_state_from_jax(jstate)
    state = optimizer.state_dict()
    assert int(state["count"]) == jadam["count"] == STEPS
    for key in ("mu", "nu"):
        for k, v in jadam[key].items():
            np.testing.assert_allclose(state[key][k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * float(v.abs().max()), err_msg=f"{key} {k}")
    assert engine.global_steps == STEPS and engine.micro_steps == STEPS * GAS


def test_llama_engine_resumes_bitwise(tmp_path):
    """Train 3 steps, save, 3 more; an engine from other weights loads the
    save and runs the same 3: losses, parameters, moments and count equal
    bit for bit (the untied lm_head is a leaf like any other)."""
    def engine(seed):
        model = tgpt.GPT(make_config(tgpt, "llama-g2", dtype="float32", remat=True),
                         device="cpu", seed=seed)
        return dst.initialize(model=model, config=engine_config(), device="cpu")[0]
    bs = [batch(300, MICRO, SEQ, seed=40 + i, gas=GAS) for i in range(6)]
    whole = engine(0)
    assert "lm_head" in dict(whole.module.named_parameters())
    want = [float(whole.train_batch(batch=b)) for b in bs]
    first = engine(0)
    got = [float(first.train_batch(batch=b)) for b in bs[:3]]
    first.save_checkpoint(str(tmp_path))
    resumed = engine(99)
    resumed.load_checkpoint(str(tmp_path))
    got += [float(resumed.train_batch(batch=b)) for b in bs[3:]]
    assert got == want
    for (k, a), b in zip(whole.module.named_parameters(), resumed._leaves):
        assert torch.equal(a, b), k
    oa, ob = whole.optimizer, resumed.optimizer
    assert all(torch.equal(a, b) for a, b in zip(oa.mu + oa.nu, ob.mu + ob.nu))
    assert int(oa.count) == int(ob.count) == 6
