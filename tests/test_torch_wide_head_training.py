"""Training at head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J-6B): the port's
flash dQ and dKV at those widths (``deepspeed_tpu_torch/ops/cuda/
flash_attention.py``) and the families' training through them, against
the JAX package on the CPU.

* The plain ``flash_backward_dq`` / ``flash_backward_dkv`` against JAX's
  ``flash_block_bwd`` in interpret mode, given the same lse and delta, and
  the gradients through the public ``flash_attention`` against
  ``jax.grad`` of JAX's Pallas ``flash_attention``, over the served widths'
  cases of ``tests/test_torch_flash_attention.py`` (GQA, ALiBi, a dense
  bias without the causal mask), fp32 and bf16, with that file's
  tolerances.
* ``gpt_loss`` and every gradient against ``jax.value_and_grad`` of JAX's
  for the tiny GPT-J (head_dim 256) and GPT-NeoX (head_dim 96) models of
  ``tests/test_torch_families.py`` at S 288 (the flash path), remat on
  and off, with ``tests/test_torch_family_training.py``'s tolerances.
* Three ``train_batch`` steps of the tiny head_dim-256 GPT-J engine
  against the JAX engine, as ``test_engine_trajectory_matches_the_jax_engine``
  holds the others (at its S 16).

On the card (``cuda``-marked, skipped here): each kernel against its
plain version over the served widths' kernel cases of
``tests/test_torch_flash_attention.py`` (S 2048 at NeoX-20B's and GPT-J's
heads, a ragged S, GQA 4, ALiBi, a dense bias at S 129, S 65), fp32 and
bf16, with that file's kernel tolerances, and the public op's gradients
launching the kernels.  Inputs come from a seed with numpy.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import adam_state_from_jax, params_from_jax
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from tests import test_torch_families as family_tests
from tests import test_torch_family_training as training_tests
from tests import test_torch_flash_attention as flash_tests

SERVING_CASES = sorted(flash_tests.SERVING_CASES)
DTYPES = sorted(flash_tests.DTYPES)
WIDE_MODELS = ["gptj-d256", "neox-d96"]
FLASH_SEQ = 288                  # above 256 tokens "auto" takes flash
N_POSITIONS = training_tests.N_POSITIONS


# --------------------------------------------------------------------------- #
# the plain dQ and dKV against JAX's Pallas kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SERVING_CASES)
def test_backward_at_head_dims_96_256_matches_pallas_block_bwd(case, dtype):
    """dq, dk, dv of both packages from the same lse (JAX's forward) and the
    same delta, at head_dim 96 and 256."""
    assert flash_tests.make_case(case)[0][0].shape[-1] in (96, 256)
    flash_tests.test_backward_matches_pallas_block_bwd(case, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SERVING_CASES)
def test_grads_at_head_dims_96_256_match_jax_grad_of_pallas_flash(case, dtype):
    """o and the gradients of sum(o^2) through the public flash_attention
    against jax.grad of JAX's Pallas flash (interpret mode)."""
    flash_tests.test_grads_match_jax_grad_of_pallas_flash(case, dtype)


# --------------------------------------------------------------------------- #
# the families' loss and gradients through flash
# --------------------------------------------------------------------------- #
def make_config(pkg, name, **extra):
    family, kw = family_tests.TINY[name]
    return family_tests.make_config(pkg, family, dict(kw, n_positions=N_POSITIONS), **extra)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", WIDE_MODELS)
def test_gpt_loss_and_every_grad_match_jax_through_flash(monkeypatch, name, remat):
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    jcfg = make_config(jgpt, name, dtype="float32", remat=remat)
    jtree = training_tests.jax_params(jcfg)
    ids, labels = training_tests.batch(jcfg.vocab_size, 1, FLASH_SEQ, seed=5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels)))(
        jax.tree.map(jnp.asarray, jtree))
    cfg = make_config(tgpt, name, dtype="float32", remat=remat)
    assert cfg.head_dim in (96, 256)
    model = tgpt.GPT(cfg, device="cpu", state_dict=params_from_jax(jtree))
    for p in model.parameters():
        p.requires_grad_(True)
    tfa.reset_counts()
    loss = tgpt.gpt_loss(cfg, model.param_tree(), torch.from_numpy(ids),
                         torch.from_numpy(labels))
    loss.backward()
    # flash's plain versions: the forward once a layer (remat keeps o and
    # lse), dQ and dKV once
    L = cfg.n_layer
    assert (tfa.flash_forward_reference.calls, tfa.flash_backward_dq_reference.calls,
            tfa.flash_backward_dkv_reference.calls) == (L, L, L)
    tfa.reset_counts()
    assert abs(float(loss.detach()) - float(jloss)) <= (training_tests.LOSS_RTOL
                                                         * abs(float(jloss)))
    want = params_from_jax(jgrads)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        # GPT-J's second norm is out of its forward: no gradient here, zeros in JAX
        grad = got[k].grad if got[k].grad is not None else torch.zeros_like(got[k])
        np.testing.assert_allclose(grad.numpy(), g.numpy(), rtol=0,
                                   atol=training_tests.GRAD_TOL * float(g.abs().max()),
                                   err_msg=k)


# --------------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------------- #
def test_gptj_d256_engine_trajectory_matches_the_jax_engine(monkeypatch):
    """The tolerances of test_engine_trajectory_matches_the_jax_engine
    (``tests/test_torch_family_training.py``): losses and grad norms within
    1e-5 relative, moments within 1e-4 of their largest magnitude, final
    parameters within 2e-5 absolute except where a step's gradient was at
    rounding level (held to Adam's 2 lr a step); at that test's S 16 (the
    reference attention: flash's gradients at 256 are held above)."""
    monkeypatch.setenv("DST_PALLAS_CE", "1")
    monkeypatch.setenv("DST_PALLAS_FUSED_OPT", "1")
    config = training_tests.engine_config()
    lr, steps, gas, micro, seq = (training_tests.ENGINE_LR, training_tests.STEPS,
                                  training_tests.GAS, training_tests.MICRO, training_tests.SEQ)
    jcfg = make_config(jgpt, "gptj-d256", dtype="float32", scan_layers=True)
    jtree = training_tests.jax_params(jcfg)
    batches = [training_tests.batch(jcfg.vocab_size, micro, seq, seed=20 + i, gas=gas)
               for i in range(steps)]
    jlosses, jnorms, jfinal, jstate = training_tests.run_jax_engine(jcfg, jtree, batches, config)

    model = tgpt.GPT(make_config(tgpt, "gptj-d256", dtype="float32"), device="cpu")
    assert model.cfg.head_dim == 256
    engine, optimizer, _, _ = dst.initialize(model=model, config=config,
                                             model_parameters=params_from_jax(jtree),
                                             device="cpu")
    names = [k for k, _ in model.named_parameters()]
    losses, norms, rounding_level = [], [], None
    for ids, labels in batches:
        losses.append(float(engine.train_batch(batch=(ids, labels))))
        norms.append(engine.get_global_grad_norm())
        small = [(g.abs() <= training_tests.GRAD_TOL * g.abs().max()).view_as(p)
                 for g, p in zip(engine._grads, model.parameters())]
        rounding_level = small if rounding_level is None else [
            a | b for a, b in zip(rounding_level, small)]
    assert min(jnorms) > training_tests.CLIP and min(norms) > training_tests.CLIP
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-5)
    want = params_from_jax(jfinal)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, held in zip(names, rounding_level):
        diff = np.abs(got[k].detach().numpy() - want[k].numpy())
        assert diff.max() <= 2 * lr * steps, k
        rest = diff[~held.numpy()]
        assert rest.size == 0 or rest.max() <= 2e-5, (k, rest.max())
    jadam = adam_state_from_jax(jstate)
    state = optimizer.state_dict()
    assert int(state["count"]) == jadam["count"] == steps
    for key in ("mu", "nu"):
        for k, v in jadam[key].items():
            np.testing.assert_allclose(state[key][k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * float(v.abs().max()), err_msg=f"{key} {k}")


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(flash_tests.SERVING_KERNEL_CASES))
def test_cuda_backward_at_head_dims_96_256_matches_plain(cuda_device, case, dtype):
    """dQ and dKV each launch their kernel once and agree with their plain
    versions (exact products) given the plain forward's lse and delta:
    max |err| / max |plain| and |err|_2 / |plain|_2 within KERNEL_TOL."""
    (q, k, v, do), bias, slopes, causal = flash_tests.kernel_inputs(case, dtype, cuda_device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ro, rlse = tfa.flash_forward_reference(q, k, v, bias, slopes, causal, scale)
    delta = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, bias, slopes, causal, scale)
    tfa.reset_counts()
    dq = tfa.flash_backward_dq(*args)
    dk, dv = tfa.flash_backward_dkv(*args)
    assert (tfa.flash_backward_dq.launches, tfa.flash_backward_dkv.launches) == (1, 1)
    rdq = tfa.flash_backward_dq_reference(*args)
    rdk, rdv = tfa.flash_backward_dkv_reference(*args)
    torch.cuda.synchronize()
    max_tol, l2_tol = flash_tests.KERNEL_TOL[dtype]
    for got, want, what in ((dq, rdq, "dq"), (dk, rdk, "dk"), (dv, rdv, "dv")):
        assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
        assert torch.isfinite(got.float()).all(), what
        err_max, err_l2 = flash_tests.kernel_errors(got, want)
        assert err_max <= max_tol and err_l2 <= l2_tol, \
            f"{what}: max {err_max:.3e} (tol {max_tol}), L2 {err_l2:.3e} (tol {l2_tol})"
    tfa.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["d96-gqa4-s320", "d256-alibi-s256"])
def test_cuda_public_op_gradients_at_head_dims_96_256_launch_the_kernels(cuda_device, case,
                                                                        dtype):
    """flash_attention's backward at head_dim 96 and 256 runs the three
    kernels once each, never a plain version, and its gradients equal those
    of the kernels called directly on the op's own o and lse."""
    (q, k, v, do), _, slopes, causal = flash_tests.kernel_inputs(case, dtype, cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.reset_counts()
    o = tattn.flash_attention(*leaves, causal=causal, alibi=slopes)
    o.backward(do)
    assert (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
            tfa.flash_backward_dkv.launches) == (1, 1, 1)
    assert (tfa.flash_forward_reference.calls, tfa.flash_backward_dq_reference.calls,
            tfa.flash_backward_dkv_reference.calls) == (0, 0, 0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o2, lse = tfa.flash_forward(q, k, v, None, slopes, causal, scale)
    delta = (o2.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    want = tfa.flash_block_bwd(q, k, v, do, lse, delta, None, slopes, causal=causal,
                               scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(o.detach(), o2)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    tfa.reset_counts()
