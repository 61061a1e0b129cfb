"""Parity of the port's training slice with the JAX package's, on the CPU.

* ``DeepSpeedConfig``: the batch arithmetic and named errors of
  ``tests/unit/test_config.py`` that apply at world size 1, case by case
  against the JAX config.
* ``gpt_loss``: the loss and every gradient against ``jax.value_and_grad``
  of the JAX ``gpt_loss`` (fp32, remat on and off) for ``tiny`` (vocab 300
  padded to 384) and a 2-layer model at GPT-2's width (E 768, 12 heads,
  B 2), at S 32 (reference attention) and above 256 tokens (S 320 and
  288: the port's flash plain versions against JAX's reference, which JAX
  runs for flash off the TPU).  Tolerance: the loss within 1e-5 relative,
  each gradient within 1e-4 of its largest magnitude (fp32 sums in other
  orders, through layer norms and a softmax).
* Remat keeps the flash op's o and lse: the flash forward runs once per
  layer per forward and backward.
* Block-sparse attention through the model: a name given to
  ``register_attention`` reaches ``gpt_forward`` through
  ``cfg.attn_impl`` in both packages; with an adapter over
  ``SparseSelfAttention`` (a block-64 "fixed" unidirectional layout from a
  ds_config ``sparse_attention`` block) a 2-layer GPT-2-width model at S
  256 matches JAX's loss and every gradient (remat on and off, the same
  tolerances), and under remat the sparse forward runs twice per layer
  (JAX's policy saves only flash's outputs), dQ and dKV once.  The engine
  trajectory below is also run with ``tiny`` on that path (block 32, S
  128).
* The engine: three ``train_batch`` steps (fp32, AdamW wd 0.01, clip 1.0
  binding, GAS 2) against the JAX engine on a one-device mesh with both
  Pallas gates on (cross-entropy and fused Adam in interpret mode), from
  the same parameters.  Tolerance: losses and grad norms within 1e-5
  relative; moments within 1e-4 of their largest magnitude; final
  parameters within 2e-5 absolute, except the attention key bias, whose
  gradient is zero in exact arithmetic (softmax is shift-invariant): its
  fp32 gradient is rounding noise that Adam normalizes to steps of about
  lr, so it is held only to Adam's bound, 2 * lr per step.
* The lr schedules, ``update_scale`` sequences and the attention dispatch.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JConfigError
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import adam_state_from_jax, params_from_jax
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError as TConfigError
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

# --------------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------------- #
CONFIG_CASES = {
    "full": {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
             "gradient_accumulation_steps": 2},
    "solve-gas": {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2},
    "solve-micro": {"train_batch_size": 4, "gradient_accumulation_steps": 2},
    "solve-train": {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2},
    "train-only": {"train_batch_size": 8},
    "micro-only": {"train_micro_batch_size_per_gpu": 8},
    "invalid": {"train_batch_size": 5, "train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2},
    "missing": {},
    "non-positive": {"train_batch_size": 1, "train_micro_batch_size_per_gpu": 2},
    "fp16-and-bf16": {"train_batch_size": 8, "fp16": {"enabled": True},
                      "bf16": {"enabled": True}},
    "zero-aliases": {"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "stage3_max_live_parameters": 12345, "stage3_prefetch_bucket_size": 777,
        "offload_optimizer": {"device": "cpu"}}},
    "unknown-keys": {"train_batch_size": 8, "zero_optimization": {"stage": 1, "future": True}},
    "sparse-attention": {"train_batch_size": 8, "sparse_attention": {
        "mode": "bigbird", "block": 64, "num_random_blocks": 2}},
    "sparse-attention-unknown-mode": {"train_batch_size": 8,
                                      "sparse_attention": {"mode": "nope"}},
    "sparse-attention-not-a-dict": {"train_batch_size": 8, "sparse_attention": "fixed"},
    "blocks": {"train_batch_size": 8,
               "optimizer": {"type": "AdamW", "params": {"lr": 0.001, "weight_decay": 0.01}},
               "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
               "fp16": {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 500},
               "gradient_clipping": 1.0},
}


def config_view(cfg):
    zc = cfg.zero_config
    return (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps, zc.stage, zc.max_live_parameters,
            zc.prefetch_bucket_size, str(getattr(zc.offload_optimizer, "device", None)),
            cfg.optimizer_name, cfg.optimizer_params, cfg.scheduler_name,
            cfg.fp16_config.enabled, cfg.fp16_config.initial_scale_power,
            cfg.fp16_config.loss_scale_window, cfg.gradient_clipping, cfg.sparse_attention)


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_matches_jax_at_world_size_1(case):
    """Same values, or the same exception type (the config errors, and the
    sparse_attention block's ValueError and NotImplementedError)."""
    raw = CONFIG_CASES[case]
    try:
        want = config_view(JConfig(raw, world_size=1))
    except (JConfigError, ValueError, NotImplementedError) as e:
        with pytest.raises((TConfigError, ValueError, NotImplementedError)) as got:
            TConfig(raw, world_size=1)
        assert type(e).__name__ == type(got.value).__name__
        return
    assert config_view(TConfig(raw, world_size=1)) == want


def test_config_from_path_rejects_duplicate_keys(tmp_path):
    p = tmp_path / "ds.json"
    p.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    with pytest.raises(ValueError):
        TConfig(str(p))
    p.write_text(json.dumps(CONFIG_CASES["full"]))
    assert TConfig(str(p)).gradient_accumulation_steps == 2
    assert TConfig(CONFIG_CASES["blocks"]).precision_dtype == torch.float16


# --------------------------------------------------------------------------- #
# gpt_loss and its gradients
# --------------------------------------------------------------------------- #
MODELS = {
    "tiny": dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=4),
    "gpt2-width-2-layers": dict(vocab_size=1000, n_positions=32, n_embd=768, n_layer=2,
                                n_head=12),
}
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def jax_model(name, seed=0, scale=1.0, **kw):
    cfg = jgpt.GPTConfig(dtype="float32", **MODELS[name], **kw)
    params = jgpt.GPT(cfg).init_params(jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda a: np.asarray(a) * (scale if np.ndim(a) >= 2 else 1.0), params)
    return cfg, params


def batch(vocab, B, S, seed, gas=None):
    rng = np.random.default_rng(seed)
    shape = (B, S) if gas is None else (gas, B, S)
    ids = rng.integers(0, vocab, shape).astype(np.int32)
    return ids, np.roll(ids, -1, axis=-1)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_gpt_loss_and_every_grad_match_jax(monkeypatch, name, remat):
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    B, S = 2, 32
    jcfg, jparams = jax_model(name, remat=remat)
    ids, labels = batch(jcfg.vocab_size, B, S, seed=3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels)))(
        jax.tree.map(jnp.asarray, jparams))
    tcfg = tgpt.GPTConfig(dtype="float32", remat=remat, **MODELS[name])
    model = tgpt.GPT(tcfg, device="cpu", state_dict=params_from_jax(jparams))
    tree = model.param_tree()
    for p in model.parameters():
        p.requires_grad_(True)
    loss = tgpt.gpt_loss(tcfg, tree, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = params_from_jax(jgrads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(g.abs().max()), err_msg=k)


# above XLA_FUSED_MAX_SEQ (256) attn_impl="auto" takes flash: the port's
# plain flash versions on the CPU, JAX's reference off the TPU
LONG_MODELS = {"tiny": (320, 320), "gpt2-width-2-layers": (288, 288)}     # n_positions, S


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(LONG_MODELS))
def test_gpt_loss_and_every_grad_match_jax_above_256(monkeypatch, name, remat):
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    n_positions, S = LONG_MODELS[name]
    dims = dict(MODELS[name], n_positions=n_positions)
    jcfg = jgpt.GPTConfig(dtype="float32", remat=remat, **dims)
    jparams = jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0))
    ids, labels = batch(jcfg.vocab_size, 2, S, seed=9)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels)))(jparams)
    tcfg = tgpt.GPTConfig(dtype="float32", remat=remat, **dims)
    model = tgpt.GPT(tcfg, device="cpu", state_dict=params_from_jax(jparams))
    for p in model.parameters():
        p.requires_grad_(True)
    tfa.reset_counts()
    loss = tgpt.gpt_loss(tcfg, model.param_tree(), torch.from_numpy(ids),
                         torch.from_numpy(labels))
    loss.backward()
    assert tfa.flash_forward_reference.calls == tcfg.n_layer       # flash, not the reference
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = params_from_jax(jgrads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(g.abs().max()), err_msg=k)


@pytest.mark.parametrize("policy", ["saves flash o and lse", "nothing saveable"])
def test_remat_runs_the_flash_forward_once_per_layer(monkeypatch, policy):
    """With remat, a block keeps its input plus the flash op's o and lse, as
    JAX's checkpoint_policy does: one forward and backward of an L-layer
    model runs the flash forward L times (2L when the policy saves
    nothing, the recompute re-running it), dQ and dKV L times each."""
    if policy == "nothing saveable":
        monkeypatch.setattr(checkpointing, "SAVED_OPS", frozenset())
    cfg = tgpt.GPTConfig(dtype="float32", remat=True, **dict(MODELS["tiny"], n_layer=3,
                                                              n_positions=300))
    model = tgpt.GPT(cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    ids, labels = batch(cfg.vocab_size, 2, 300, seed=10)
    tfa.reset_counts()
    loss = tgpt.gpt_loss(cfg, model.param_tree(), torch.from_numpy(ids),
                         torch.from_numpy(labels))
    assert tfa.flash_forward_reference.calls == cfg.n_layer
    loss.backward()
    L = cfg.n_layer
    forwards = L if policy == "saves flash o and lse" else 2 * L
    assert (tfa.flash_forward_reference.calls, tfa.flash_backward_dq_reference.calls,
            tfa.flash_backward_dkv_reference.calls) == (forwards, L, L)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    tfa.reset_counts()


# --------------------------------------------------------------------------- #
# block-sparse attention through the model
# --------------------------------------------------------------------------- #
# a ds_config sparse_attention block: the Sparse Transformer "fixed"
# pattern, causal (at S 256 with block 64: row blocks 0-3 list {0}, {0, 1},
# {1, 2}, {1, 2, 3})
SPARSE_BLOCK = {"mode": "fixed", "block": 64, "num_local_blocks": 2, "num_global_blocks": 1,
                "attention": "unidirectional"}


def sparse_attention_fn(pkg, block, num_heads, max_seq_length):
    """The adapter a user of either package writes: the config block ->
    SparsityConfig -> SparseSelfAttention, behind the attention contract."""
    module = pkg.SparseSelfAttention(
        pkg.sparsity_config.sparsity_config_from_dict(block, num_heads=num_heads),
        max_seq_length=max_seq_length)

    def fn(q, k, v, *, causal, bias=None, alibi=None):
        if bias is not None or alibi is not None:
            raise NotImplementedError("block-sparse attention takes no bias or ALiBi slopes")
        return module(q, k, v)
    return fn


@pytest.fixture
def own_registries(monkeypatch):
    """Registrations made in a test go with it."""
    monkeypatch.setattr(jattn, "_REGISTRY", dict(jattn._REGISTRY))
    monkeypatch.setattr(tattn, "_REGISTRY", dict(tattn._REGISTRY))


def register_sparse(block, num_heads, max_seq_length):
    jattn.register_attention("block_sparse", sparse_attention_fn(jsa, block, num_heads,
                                                                 max_seq_length))
    tattn.register_attention("block_sparse", sparse_attention_fn(tsa, block, num_heads,
                                                                 max_seq_length))


def test_a_registered_name_reaches_gpt_forward_in_both_packages(own_registries):
    calls = {"jax": [], "torch": []}

    def spy(attention, pkg):
        def fn(q, k, v, **kw):
            calls[pkg].append(tuple(q.shape))
            return attention(q, k, v, **kw)
        return fn
    jattn.register_attention("spy", spy(jattn.reference_attention, "jax"))
    tattn.register_attention("spy", spy(tattn.reference_attention, "torch"))
    assert tattn.get_attention_fn("spy") is tattn._REGISTRY["spy"]
    jcfg, jparams = jax_model("tiny", attn_impl="spy")
    ids = batch(jcfg.vocab_size, 2, 16, seed=30)[0]
    want = jgpt.gpt_forward(jcfg, jparams, jnp.asarray(ids))
    cfg = tgpt.GPTConfig(dtype="float32", attn_impl="spy", **MODELS["tiny"])
    model = tgpt.GPT(cfg, device="cpu", state_dict=params_from_jax(jparams))
    got = tgpt.gpt_forward(cfg, model.param_tree(), torch.from_numpy(ids))
    # JAX traces its scanned block once; the port calls it per layer
    assert calls == {"jax": [(2, 16, 4, 8)], "torch": [(2, 16, 4, 8)] * cfg.n_layer}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError, match="no bias"):
        sparse_attention_fn(tsa, SPARSE_BLOCK, 4, 128)(*(torch.zeros(1, 64, 4, 8),) * 3,
                                                       causal=True, alibi=np.ones(4))


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_loss_and_every_grad_match_jax_through_sparse_attention(monkeypatch, own_registries,
                                                                    remat):
    """A 2-layer GPT-2-width model (E 768, 12 heads) at S 256 with
    attn_impl "block_sparse": loss and every gradient against JAX's (its
    Pallas kernels in interpret mode).  The plain sparse versions run: the
    forward twice per layer under remat (nothing of the op is saved, as in
    JAX), once without; dQ and dKV once per layer."""
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    S = 256
    register_sparse(SPARSE_BLOCK, 12, S)
    dims = dict(MODELS["gpt2-width-2-layers"], n_positions=S)
    jcfg = jgpt.GPTConfig(dtype="float32", remat=remat, attn_impl="block_sparse", **dims)
    jparams = jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0))
    ids, labels = batch(jcfg.vocab_size, 2, S, seed=31)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels)))(jparams)
    tcfg = tgpt.GPTConfig(dtype="float32", remat=remat, attn_impl="block_sparse", **dims)
    model = tgpt.GPT(tcfg, device="cpu", state_dict=params_from_jax(jparams))
    for p in model.parameters():
        p.requires_grad_(True)
    tbs.reset_counts()
    tfa.reset_counts()
    loss = tgpt.gpt_loss(tcfg, model.param_tree(), torch.from_numpy(ids),
                         torch.from_numpy(labels))
    loss.backward()
    L = tcfg.n_layer
    assert (tbs.block_sparse_forward_reference.calls, tbs.block_sparse_backward_dq_reference.calls,
            tbs.block_sparse_backward_dkv_reference.calls) == ((2 * L if remat else L), L, L)
    assert tfa.flash_forward_reference.calls == 0
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = params_from_jax(jgrads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(g.abs().max()), err_msg=k)
    tbs.reset_counts()


def test_gpt_forward_logits_match_the_inference_path():
    """``gpt_forward`` without ``return_hidden`` gives the logits that
    ``apply_with_cache`` (the inference path) gives on the same prompt."""
    jcfg, jparams = jax_model("tiny", scale=4.0)
    cfg = tgpt.GPTConfig(dtype="float32", **MODELS["tiny"])
    model = tgpt.GPT(cfg, device="cpu", state_dict=params_from_jax(jparams))
    ids = torch.from_numpy(batch(cfg.vocab_size, 2, 16, seed=4)[0])
    logits = tgpt.gpt_forward(cfg, model.param_tree(), ids)
    ref, _ = model.apply_with_cache(ids, model.init_cache(2, 16))
    torch.testing.assert_close(logits, ref, rtol=0, atol=1e-4)


def test_training_knobs_not_ported_raise():
    cfg = tgpt.GPTConfig(dtype="float32", dropout=0.1, **MODELS["tiny"])
    model = tgpt.GPT(cfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="dropout"):
        model(model.param_tree(), (ids, ids))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgpt.gpt_loss(cfg, model.param_tree(), ids, ids, train=False, pld_theta=0.5)


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


# the tiny model on the block-sparse path: block 32 at S 128 (4 row blocks)
SPARSE_TINY_BLOCK = dict(SPARSE_BLOCK, block=32)
SPARSE_TINY_SEQ = 128


def test_engine_trajectory_matches_the_jax_engine(monkeypatch):
    check_engine_trajectory(monkeypatch, "auto")


def test_engine_trajectory_matches_the_jax_engine_through_sparse_attention(monkeypatch,
                                                                          own_registries):
    """The ds_config carries the sparse_attention block, which both engines
    accept, and the models' attn_impl names the adapter built from it."""
    check_engine_trajectory(monkeypatch, "block_sparse")


def check_engine_trajectory(monkeypatch, attention):
    monkeypatch.setenv("DST_PALLAS_CE", "1")
    monkeypatch.setenv("DST_PALLAS_FUSED_OPT", "1")
    config, seq, dims = engine_config(), SEQ, dict(MODELS["tiny"])
    if attention == "block_sparse":
        seq = SPARSE_TINY_SEQ
        config["sparse_attention"] = SPARSE_TINY_BLOCK
        dims.update(n_positions=seq, attn_impl="block_sparse")
        register_sparse(SPARSE_TINY_BLOCK, dims["n_head"], seq)
    jcfg = jgpt.GPTConfig(dtype="float32", scan_layers=True, **dims)
    jparams = jax.tree.map(lambda a: np.asarray(a) * (4.0 if np.ndim(a) >= 2 else 1.0),
                           jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    batches = [batch(jcfg.vocab_size, MICRO, seq, seed=20 + i, gas=GAS) for i in range(STEPS)]
    jlosses, jnorms, jfinal, jstate = run_jax_engine(jcfg, jparams, batches, config)

    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **dims), device="cpu")
    tbs.reset_counts()
    engine, optimizer, loader, sched = dst.initialize(
        model=model, config=config, model_parameters=params_from_jax(jparams),
        device="cpu")
    assert optimizer is engine.optimizer and loader is None and sched is None
    losses, norms = [], []
    for ids, labels in batches:
        loss = engine.train_batch(batch=(ids, labels))
        assert loss.shape == () and loss.device.type == "cpu"
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
    assert min(jnorms) > CLIP and min(norms) > CLIP     # the clip binds every step
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-5)
    want = params_from_jax(jfinal)
    got = dict(model.named_parameters())
    E = jcfg.n_embd
    for k, v in want.items():
        diff = np.abs(got[k].detach().numpy() - v.numpy())
        assert diff.max() <= 2 * ENGINE_LR * STEPS, k
        if k.endswith("qkv_b"):
            diff = np.concatenate([diff[:E], diff[2 * E:]])     # all but the key bias
        assert diff.max() <= 2e-5, (k, diff.max())
    jadam = adam_state_from_jax(jstate)
    state = engine.optimizer.state_dict()
    assert int(state["count"]) == jadam["count"] == STEPS
    for key in ("mu", "nu"):
        for k, v in jadam[key].items():
            np.testing.assert_allclose(state[key][k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * float(v.abs().max()), err_msg=f"{key} {k}")
    assert engine.global_steps == STEPS and engine.micro_steps == STEPS * GAS
    sparse_calls = tbs.block_sparse_forward_reference.calls
    assert sparse_calls == (STEPS * GAS * jcfg.n_layer if attention == "block_sparse" else 0)
    tbs.reset_counts()


def test_forward_backward_step_equals_train_batch():
    """The micro-step API accumulates the same gradients and takes the same
    step as ``train_batch`` (bit for bit on the CPU)."""
    jcfg, jparams = jax_model("tiny", seed=5)
    sd = params_from_jax(jparams)
    ids, labels = batch(jcfg.vocab_size, MICRO, SEQ, seed=6, gas=GAS)
    engines = []
    for _ in range(2):
        model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
        engines.append(dst.initialize(model=model, config=engine_config(),
                                      model_parameters=sd, device="cpu")[0])
    fused = engines[0].train_batch(batch=(ids, labels))
    micro = engines[1]
    for i in range(GAS):
        loss = micro.forward(ids[i], labels[i])
        micro.backward(loss)
        micro.step()
        assert micro.global_steps == (1 if i == GAS - 1 else 0)
    for (k, a), (_, b) in zip(engines[0].module.named_parameters(),
                              micro.module.named_parameters()):
        assert torch.equal(a, b), k
    assert float(fused) > 0


@pytest.mark.parametrize("config,item", [
    ({"zero_optimization": {"stage": 3, "offload_optimizer": {"device": "nvme"}}}, "item 7"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True}}, "item 7"),
    ({"fp16": {"enabled": True}}, "item 5"),
    ({"optimizer": {"type": "Lamb"}}, "item 5"),
    ({"wall_clock_breakdown": True}, "item 8"),
    ({"activation_checkpointing": {"partition_activations": True}}, "item 6"),
    ({"activation_checkpointing": {"cpu_checkpointing": True}}, "item 7"),
    ({"compression_training": {"weight_quantization": {"shared_parameters": {}}}}, "item 9"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}}, "item 7"),
    ({"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}}, "item 7"),
])
def test_engine_rejects_what_is_not_ported(config, item):
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue 1 {item}"):
        dst.initialize(model=model, device="cpu",
                       config=dict({"train_micro_batch_size_per_gpu": 1}, **config))


def test_engine_schedule_feeds_the_kernel_lr_on_the_device_count():
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
    engine, _, _, sched = dst.initialize(model=model, device="cpu", config=dict(
        engine_config(), scheduler={"type": "WarmupLR", "params": {
            "warmup_num_steps": 4, "warmup_max_lr": 1e-3, "warmup_type": "linear"}}))
    ids, labels = batch(300, MICRO, SEQ, seed=7, gas=GAS)
    lrs = []
    for _ in range(3):
        lrs.append(engine.get_lr()[0])
        engine.train_batch(batch=(ids, labels))
    assert lrs == pytest.approx([0.0, 2.5e-4, 5e-4])
    assert sched.last_batch_iteration == 2 and int(engine.optimizer.count) == 3


# --------------------------------------------------------------------------- #
# schedules, loss scaling, attention dispatch, throughput timer
# --------------------------------------------------------------------------- #
SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=20)),
    ("WarmupLR", dict(warmup_max_lr=3e-4, warmup_num_steps=10, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=40, warmup_max_lr=1e-3, warmup_num_steps=10)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                         lr_range_test_step_rate=2.0, lr_range_test_staircase=True)),
    ("OneCycle", dict(cycle_min_lr=1e-5, cycle_max_lr=1e-3, cycle_first_step_size=10,
                      decay_lr_rate=0.1, decay_step_size=5)),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[s[0] + str(i) for i, s in
                                                         enumerate(SCHEDULES)])
def test_lr_schedules_match_jax(name, params):
    """fp32, steps 0..59; within 1 ulp (the log warmup's log is the CPU
    math library's on one side and XLA's on the other)."""
    jfn = jlr.get_lr_schedule(name, params).schedule_fn()
    tfn = tlr.get_lr_schedule(name, params).schedule_fn()
    steps = np.arange(60)
    want = np.asarray([np.float32(jfn(s)) for s in steps])
    got = np.asarray([tfn(int(s)).item() for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)
    sched = tlr.get_lr_schedule(name, params)
    sched.step()
    sched.step()
    assert sched.get_lr() == [pytest.approx(float(want[1]), rel=1e-6)]


SCALER_KW = [dict(initial_scale_power=4, loss_scale_window=3, hysteresis=2),
             dict(initial_scale_power=3, loss_scale_window=2, hysteresis=1, min_loss_scale=4.0),
             dict(initial_scale_power=4, loss_scale_window=3, hysteresis=2,
                  consecutive_hysteresis=True),
             dict(static_loss_scale=128.0)]
OVERFLOWS = [False, False, True, False, True, True, False, False, False, True, False,
             False, False, False, True, True, True]


@pytest.mark.parametrize("kw", SCALER_KW, ids=[str(i) for i in range(len(SCALER_KW))])
def test_update_scale_sequences_match_jax(kw):
    js, ts = jls.create_loss_scaler(**kw), tls.create_loss_scaler(**kw)
    update = jax.jit(jls.update_scale)
    for i, ovf in enumerate(OVERFLOWS):
        js = update(js, jnp.asarray(ovf))
        ts = tls.update_scale(ts, torch.tensor(ovf))
        for field in jls.LossScalerState._fields:
            assert np.asarray(getattr(js, field)).item() == getattr(ts, field).item(), (i, field)


def test_unit_scaler_is_static_one():
    s = tls.unit_loss_scaler()
    assert float(s.scale) == 1.0 and not bool(s.dynamic)
    assert float(tls.update_scale(s, torch.tensor(True)).scale) == 1.0


def test_auto_attention_uses_the_reference_on_the_cpu_above_256():
    """Up to 256 tokens ``auto`` is the reference; above, it is flash, whose
    plain version runs on the CPU and agrees with the reference (and with
    JAX's) within fp32 2e-5."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 300, 2, 8)).astype(np.float32))
               for _ in range(3))
    ref = tattn.reference_attention(q, k, v, causal=True)
    tfa.reset_counts()
    got = tattn.auto_attention(q, k, v, causal=True)
    assert tfa.flash_forward_reference.calls == 1
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)
    torch.testing.assert_close(tattn.get_attention_fn("flash")(q, k, v, causal=True), got,
                               rtol=0, atol=0)
    short = tuple(t[:, :256] for t in (q, k, v))
    assert torch.equal(tattn.auto_attention(*short, causal=True),
                       tattn.reference_attention(*short, causal=True))
    assert tfa.flash_forward_reference.calls == 2
    from deepspeed_tpu.ops import attention as jattn
    want = jattn.reference_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.get_attention_fn("ring")
    tfa.reset_counts()


def test_throughput_timer_never_syncs_before_start_step():
    syncs = []
    timer = ThroughputTimer(batch_size=8, synchronize=lambda: syncs.append(1),
                            start_step=10 ** 12, steps_per_output=2, logging_fn=lambda m: None)
    for _ in range(5):
        timer.start()
        timer.stop(global_step=True)
    assert not syncs and timer.avg_samples_per_sec() == 0.0
    timer = ThroughputTimer(batch_size=8, synchronize=lambda: syncs.append(1),
                            start_step=1, steps_per_output=2, logging_fn=lambda m: None)
    for _ in range(5):
        timer.start()
        timer.stop(global_step=True)
    assert len(syncs) == 3 and timer.avg_samples_per_sec() > 0


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_auto_attention_launches_the_flash_kernels_above_256():
    """On the card ``auto`` at S 512 runs the flash kernels forward and
    backward, never their plain versions or the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 512, 4, 64)).astype(np.float32))
               .to("cuda", torch.bfloat16).requires_grad_() for _ in range(3))
    tfa.reset_counts()
    tattn.auto_attention(q, k, v, causal=True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
            tfa.flash_backward_dkv.launches) == (1, 1, 1)
    assert (tfa.flash_forward_reference.calls, tfa.flash_backward_dq_reference.calls,
            tfa.flash_backward_dkv_reference.calls) == (0, 0, 0)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    tfa.reset_counts()
