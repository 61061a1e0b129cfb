"""Parity of the port's flash attention (``deepspeed_tpu_torch/ops/cuda/
flash_attention.py``) with the JAX package's.

On the CPU the port's entry points run their plain versions.  They are
held, on the same numpy inputs, against

* JAX's Pallas kernels in interpret mode, as the JAX package's own tests
  run them: the forward's o and lse against ``flash_block_fwd``; dq, dk and
  dv against ``flash_block_bwd`` given the same lse and delta (both with
  64-row blocks, so every case walks several query and key blocks); and
  the gradients of ``sum(o^2)`` against ``jax.grad`` of the Pallas
  ``flash_attention``;
* JAX's ``reference_attention`` (output and gradients).

Cases: causal and non-causal, S 256 at head_dim 64, GQA with Hkv 2 and 1
at H 4, ALiBi slopes from ``alibi_slopes``, a per-head dense bias and a
rank-2 bias, and at head_dim 128 (LLaMA's and BLOOM's) GQA 4:1 and ALiBi;
each in fp32 and bf16.  Tolerance: |port - jax| <= tol *
max(1, |jax|), tol 2e-5 in fp32 (the JAX tests' own: fp32 sums in other
orders) and 2e-2 in bf16 (p, ds and the outputs are rounded to bf16 on
both sides, from fp32 values that differ by rounding noise).  Against the
reference in bf16 only the output is compared, as the JAX package's own
``test_bf16_close`` does: the reference's autodiff rounds its bf16
products (dp before ``dp - delta`` cancels), and JAX's own kernel parts
from its gradients by 2-4 % of max(1, |ref|) on these inputs.

The CUDA kernels run only on a card: the ``cuda``-marked tests skip here
and run on the GPU machine (``python -m pytest
tests/test_torch_flash_attention.py -m cuda``), where each kernel is held
against its plain version on the same inputs, over the
same cases plus a ragged S 1000, GPT-2 XL's 25 heads at S 512, a GQA
group of 3 and S around the kernels' 64-row tiles, and at head_dim 128
GQA 4:1 at a ragged S, ALiBi, a group of 3, a dense bias and S 129.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa

# name: (B, S, H, Hkv, D, causal, bias, alibi)
CASES = {
    "causal": (2, 128, 4, 4, 32, True, None, False),
    "noncausal": (2, 128, 4, 4, 32, False, None, False),
    "s256-d64": (1, 256, 2, 2, 64, True, None, False),
    "gqa-hkv2": (1, 128, 4, 2, 32, True, None, False),
    "gqa-hkv1": (1, 128, 4, 1, 32, False, None, False),
    "alibi": (1, 128, 4, 4, 32, True, None, True),
    "bias-per-head": (2, 128, 4, 4, 32, False, "per-head", False),
    "bias-rank2": (1, 128, 4, 2, 32, True, "rank2", False),
    "gqa4-d128": (1, 128, 4, 1, 128, True, None, False),
    "alibi-d128": (1, 128, 2, 2, 128, True, None, True),
}
# the widths served at head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J), whose
# kernel is the forward alone: GQA, ALiBi, a dense bias, non-causal
SERVING_CASES = {
    "gqa2-d96": (1, 128, 4, 2, 96, True, None, False),
    "alibi-d96": (1, 128, 2, 2, 96, True, None, True),
    "gqa4-d256": (1, 128, 4, 1, 256, True, None, False),
    "bias-noncausal-d256": (1, 128, 2, 2, 256, False, "per-head", False),
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BLOCK = 64              # the JAX kernels' block size in these tests
NO_EXTRAS = (None, None, True, 0.125)     # bias, slopes, causal, scale at head_dim 64


def make_case(name, seed=0, q_std=1.0):
    """numpy (q, k, v, do) in [B, S, H, D], the bias as given to the public
    functions (or None) and the slopes (or None)."""
    B, S, H, Hkv, D, causal, bias_kind, alibi = {**CASES, **SERVING_CASES}[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32) * q_std
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    bias = None
    if bias_kind == "per-head":
        bias = (rng.standard_normal((B, H, S, S)) * 0.5).astype(np.float32)
    elif bias_kind == "rank2":
        bias = (rng.standard_normal((S, S)) * 0.5).astype(np.float32)
    slopes = tattn.alibi_slopes(H) if alibi else None
    return (q, k, v, do), bias, slopes, causal


def canonical4(bias, S):
    """The bias as the block functions take it: fp32 [Bb, Hb, S, S]."""
    if bias is None:
        return None
    while bias.ndim < 4:
        bias = bias[None]
    return np.broadcast_to(bias, bias.shape[:2] + (S, S)).astype(np.float32)


def to_jax(a, dtype, bhsd=False):
    x = jnp.asarray(a, DTYPES[dtype][0])
    return x.transpose(0, 2, 1, 3) if bhsd else x


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(DTYPES[dtype][1])


def assert_close(got, want, dtype, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= TOL[dtype], f"{what}: {err:.3e} > {TOL[dtype]}"


def jax_block_forward(name, dtype):
    """(inputs, JAX o [B,S,H,D], JAX lse [B,H,S]) from flash_block_fwd."""
    (q, k, v, do), bias, slopes, causal = make_case(name)
    S, D = q.shape[1], q.shape[3]
    o, lse = jfa.flash_block_fwd(
        to_jax(q, dtype, True), to_jax(k, dtype, True), to_jax(v, dtype, True),
        None if bias is None else jnp.asarray(canonical4(bias, S)),
        None if slopes is None else jnp.asarray(slopes), causal=causal,
        scale=1.0 / np.sqrt(D), bq=BLOCK, bk=BLOCK)
    return ((q, k, v, do), bias, slopes, causal), o.transpose(0, 2, 1, 3), lse[..., 0]


def port_args(q, k, v, bias, slopes, dtype):
    S = q.shape[1]
    t_bias = None if bias is None else to_torch(canonical4(bias, S))
    t_slopes = None if slopes is None else to_torch(slopes)
    return [to_torch(x, dtype) for x in (q, k, v)], t_bias, t_slopes


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_pallas_block_fwd(case, dtype):
    ((q, k, v, _), bias, slopes, causal), jo, jlse = jax_block_forward(case, dtype)
    (tq, tk, tv), tb, ts = port_args(q, k, v, bias, slopes, dtype)
    o, lse = tfa.flash_block_fwd(tq, tk, tv, tb, ts, causal, 1.0 / math.sqrt(q.shape[3]))
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert_close(o, jo, dtype, "o")
    assert_close(lse, jlse, dtype, "lse")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_forward_at_serving_head_dims_matches_pallas_block_fwd(case, dtype):
    """The plain forward against JAX's Pallas forward (interpret mode) at
    head_dim 96 and 256, the widths the port serves."""
    test_forward_matches_pallas_block_fwd(case, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_pallas_block_bwd(case, dtype):
    """dq, dk, dv of both packages from the same lse (JAX's forward) and
    the same delta = rowsum(do * o)."""
    ((q, k, v, do), bias, slopes, causal), jo, jlse = jax_block_forward(case, dtype)
    S, D = q.shape[1], q.shape[3]
    do_c = np.asarray(to_jax(do, dtype), np.float32)
    delta = np.einsum("bshd,bshd->bhs", np.asarray(jnp.asarray(jo, jnp.float32)), do_c)
    lse = np.asarray(jlse)
    jdq, jdk, jdv = jfa.flash_block_bwd(
        to_jax(q, dtype, True), to_jax(k, dtype, True), to_jax(v, dtype, True),
        to_jax(do, dtype, True), jnp.asarray(lse[..., None]), jnp.asarray(delta[..., None]),
        None if bias is None else jnp.asarray(canonical4(bias, S)),
        None if slopes is None else jnp.asarray(slopes), causal=causal,
        scale=1.0 / np.sqrt(D), bq=BLOCK, bk=BLOCK)
    (tq, tk, tv), tb, ts = port_args(q, k, v, bias, slopes, dtype)
    dq, dk, dv = tfa.flash_block_bwd(tq, tk, tv, to_torch(do, dtype), to_torch(lse),
                                     to_torch(delta), tb, ts, causal=causal,
                                     scale=1.0 / math.sqrt(D))
    for got, want, what in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == tq.dtype
        assert_close(got, want.transpose(0, 2, 1, 3), dtype, what)


def port_value_and_grads(q, k, v, bias, slopes, causal, dtype):
    """o and the grads of sum(o^2) through the port's public flash_attention."""
    ts = [to_torch(x, dtype).requires_grad_() for x in (q, k, v)]
    o = tattn.flash_attention(*ts, causal=causal,
                              bias=None if bias is None else to_torch(bias),
                              alibi=None if slopes is None else to_torch(slopes))
    (o.float() ** 2).sum().backward()
    return o.detach(), [t.grad for t in ts]


def jax_value_and_grads(fn, q, k, v, bias, slopes, causal, dtype):
    args = [to_jax(x, dtype) for x in (q, k, v)]
    kw = dict(causal=causal, bias=None if bias is None else jnp.asarray(bias),
              alibi=None if slopes is None else jnp.asarray(slopes))
    o = fn(*args, **kw)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a, **kw).astype(jnp.float32) ** 2),
                     argnums=(0, 1, 2))(*args)
    return o, grads


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_grad_of_pallas_flash(case, dtype):
    (q, k, v, _), bias, slopes, causal = make_case(case, seed=1)

    def pallas(*a, **kw):
        return jfa.flash_attention(*a, block_q=BLOCK, block_k=BLOCK, **kw)
    jo, jgrads = jax_value_and_grads(pallas, q, k, v, bias, slopes, causal, dtype)
    o, grads = port_value_and_grads(q, k, v, bias, slopes, causal, dtype)
    assert_close(o, jo, dtype, "o")
    for got, want, what in zip(grads, jgrads, ("dq", "dk", "dv")):
        assert_close(got, want, dtype, what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_reference_attention(case, dtype):
    (q, k, v, _), bias, slopes, causal = make_case(case, seed=2)
    jo, jgrads = jax_value_and_grads(jattn.reference_attention, q, k, v, bias, slopes,
                                     causal, dtype)
    o, grads = port_value_and_grads(q, k, v, bias, slopes, causal, dtype)
    assert_close(o, jo, dtype, "o")
    if dtype == "float32":
        for got, want, what in zip(grads, jgrads, ("dq", "dk", "dv")):
            assert_close(got, want, dtype, what)


def test_a_row_the_bias_masks_wholly_averages_as_jax_does():
    """Non-causal, one query row's every column biased to -1e30: JAX's
    reference gives the uniform average of v there, and so does the port."""
    (q, k, v, _), _, _, _ = make_case("noncausal", seed=3)
    B, S, H, _ = q.shape
    bias = np.zeros((B, H, S, S), np.float32)
    bias[:, :, 5, :] = -1e30
    want = jattn.reference_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=False,
                                     bias=jnp.asarray(bias))
    got = tattn.flash_attention(*(to_torch(x) for x in (q, k, v)), causal=False,
                                bias=to_torch(bias))
    assert_close(got, want, "float32", "o")
    np.testing.assert_allclose(got[:, 5].numpy(), v.mean(1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_heads", [1, 2, 4, 8, 12, 16, 25, 32, 48])
def test_alibi_helpers_equal_jax(num_heads):
    np.testing.assert_array_equal(tattn.alibi_slopes(num_heads),
                                  jattn.alibi_slopes(num_heads))
    got = tattn.alibi_bias(num_heads, 7, 11, q_offset=3)
    want = np.asarray(jattn.alibi_bias(num_heads, 7, 11, q_offset=3))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5, 6), (3, 5, 6), (2, 3, 5, 6)])
def test_canonical_bias_equals_jax(shape):
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = tattn.canonical_bias(torch.from_numpy(a))
    want = np.asarray(jattn.canonical_bias(jnp.asarray(a)))
    assert tuple(got.shape) == want.shape == (1,) * (4 - len(shape)) + shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tattn.canonical_bias(None) is None
    with pytest.raises(ValueError, match="rank"):
        tattn.canonical_bias(torch.zeros(1, 1, 1, 2, 2))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    (q, k, v, do), _, _, _ = make_case("gqa-hkv2")
    tq, tk, tv = (to_torch(x).requires_grad_() for x in (q, k, v))
    tfa.reset_counts()
    tattn.flash_attention(tq, tk, tv, causal=True).sum().backward()
    assert (tfa.flash_forward_reference.calls, tfa.flash_backward_dq_reference.calls,
            tfa.flash_backward_dkv_reference.calls) == (1, 1, 1)
    assert (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
            tfa.flash_backward_dkv.launches) == (0, 0, 0)
    assert tk.grad.shape == tk.shape
    tfa.reset_counts()


def test_what_the_kernels_do_not_take_raises():
    """Shapes are checked before the device, so meta tensors reach the
    checks a CUDA tensor meets; a grouping that does not divide raises on
    every device.  All three kernels take head_dim 64, 96, 128 and 256;
    another width raises naming Queue 2 part A in the forward, dQ and dKV."""
    for D in (48, 80, 512):
        q = torch.empty(1, 8, 4, D, device="meta")
        stat = torch.empty(1, 4, 8, device="meta")
        with pytest.raises(NotImplementedError, match="head_dim 64, 96, 128, 256.*Queue 2 part A"):
            tfa.flash_forward(q, q, q, *NO_EXTRAS)
        for fn in (tfa.flash_backward_dq, tfa.flash_backward_dkv):
            with pytest.raises(NotImplementedError,
                               match=f"head_dim 64, 96, 128, 256, got {D}.*Queue 2 part A"):
                fn(q, q, q, q, stat, stat, None, None, True, D ** -0.5)
    for D in (96, 256):
        q = torch.empty(1, 8, 4, D, device="meta")
        stat = torch.empty(1, 4, 8, device="meta")
        with pytest.raises(ValueError, match="no kernel"):        # past the head_dim check
            tfa.flash_forward(q, q, q, *NO_EXTRAS)
        for fn in (tfa.flash_backward_dq, tfa.flash_backward_dkv):
            with pytest.raises(ValueError, match="no kernel"):    # past it too
                fn(q, q, q, q, stat, stat, None, None, True, D ** -0.5)
    q = torch.empty(1, 8, 4, 64, device="meta")
    kv = torch.empty(1, 8, 3, 64, device="meta")
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_forward(q, kv, kv, *NO_EXTRAS)
    with pytest.raises(ValueError, match="multiple"):
        tattn.flash_attention(torch.zeros(1, 8, 4, 8), torch.zeros(1, 8, 3, 8),
                              torch.zeros(1, 8, 3, 8))
    with pytest.raises(TypeError, match="Queue 1 item 5"):
        tfa.flash_forward(q.half(), q.half(), q.half(), *NO_EXTRAS)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_forward(q, q, q, *NO_EXTRAS)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# the CPU cases at head_dim 64, a ragged S and GPT-2 XL's heads
KERNEL_CASES = {
    "causal": (2, 128, 4, 4, True, None, False),
    "noncausal": (2, 200, 4, 4, False, None, False),
    "gqa-hkv2": (1, 256, 4, 2, True, None, False),
    "gqa-hkv1": (1, 192, 4, 1, False, None, False),
    "alibi": (1, 256, 4, 4, True, None, True),
    "bias-per-head": (2, 128, 4, 4, False, "per-head", False),
    "bias-rank2": (1, 256, 4, 2, True, "rank2", False),
    "ragged-s1000": (1, 1000, 2, 2, True, None, False),
    "gpt2-xl-s512": (1, 512, 25, 25, True, None, False),
    # ALiBi off the causal diagonal: the extras path on tiles that are not
    # edges; a bias at a ragged S: the extras path on tiles that cross S
    "alibi-noncausal": (1, 256, 4, 4, False, None, True),
    "bias-per-head-s200": (1, 200, 4, 4, False, "per-head", False),
    # dKV's in-block loop over a GQA group of 3 query heads
    "gqa-group3": (1, 320, 12, 4, True, None, False),
    # around the 64-row tiles of all three kernels: exactly one tile, one
    # row into a second (dKV's ragged query tile, a ragged key tile for the
    # forward and dQ), one row short of two tiles, one past, one short of
    # four
    "s64-causal": (2, 64, 4, 4, True, None, False),
    "s65-causal": (2, 65, 4, 4, True, None, False),
    "s65-noncausal": (2, 65, 4, 4, False, None, False),
    "s127-causal": (2, 127, 4, 4, True, None, False),
    "s127-noncausal": (2, 127, 4, 4, False, None, False),
    "s129-causal": (2, 129, 4, 4, True, None, False),
    "s129-noncausal": (2, 129, 4, 4, False, None, False),
    "s255-causal": (1, 255, 4, 2, True, None, False),
    "s255-noncausal": (1, 255, 4, 4, False, None, False),
    # head_dim 128 (LLaMA, BLOOM): GQA 4:1 at a ragged S, ALiBi, dKV's loop
    # over a group of 3, a dense bias without the causal mask, and one row
    # into a second tile (trailing entry: the head_dim; 64 where absent)
    "d128-gqa4-s1000": (1, 1000, 8, 2, True, None, False, 128),
    "d128-alibi-s320": (1, 320, 4, 4, True, None, True, 128),
    "d128-gqa-group3": (1, 200, 6, 2, True, None, False, 128),
    "d128-bias-per-head-s200": (1, 200, 2, 2, False, "per-head", False, 128),
    "d128-s129-noncausal": (2, 129, 2, 2, False, None, False, 128),
}
# kernel against the plain version (exact products) on the same inputs, q
# drawn so the score std is 3 (peaked rows).  Per output: max |err| / max
# |plain| and |err|_2 / |plain|_2.  fp32: sums in another order.  bf16: both
# sides round p, ds and the outputs to bf16, at points that straddle a
# rounding step where their fp32 values differ by rounding noise: one ulp
# (2^-8 relative) at most per element, far less in norm.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 5e-3)}


def kernel_inputs(case, dtype, device, seed=11):
    B, S, H, Hkv, causal, bias_kind, alibi, *head_dim = KERNEL_CASES_ALL[case]
    D = head_dim[0] if head_dim else 64
    rng = np.random.default_rng(seed)

    def dev(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt or DTYPES[dtype][1])
    q = dev(rng.standard_normal((B, S, H, D)) * 3.0)
    k, v = (dev(rng.standard_normal((B, S, Hkv, D))) for _ in range(2))
    do = dev(rng.standard_normal((B, S, H, D)))
    bias = None
    if bias_kind == "per-head":
        bias = dev(rng.standard_normal((B, H, S, S)) * 0.5, torch.float32)
    elif bias_kind == "rank2":
        bias = dev(rng.standard_normal((S, S)) * 0.5, torch.float32)[None, None].expand(
            1, 1, S, S)
    slopes = dev(tattn.alibi_slopes(H), torch.float32) if alibi else None
    return (q, k, v, do), bias, slopes, causal


def kernel_errors(got, want):
    err = (got.float() - want.float())
    return (err.abs().max() / want.float().abs().max()).item(), \
        (err.norm() / want.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_kernels_match_plain(cuda_device, case, dtype):
    (q, k, v, do), bias, slopes, causal = kernel_inputs(case, dtype, cuda_device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = tfa.flash_forward(q, k, v, bias, slopes, causal, scale)
    ro, rlse = tfa.flash_forward_reference(q, k, v, bias, slopes, causal, scale)
    delta = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = tfa.flash_backward_dq(q, k, v, do, rlse, delta, bias, slopes, causal, scale)
    rdq = tfa.flash_backward_dq_reference(q, k, v, do, rlse, delta, bias, slopes, causal,
                                          scale)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, rlse, delta, bias, slopes, causal, scale)
    rdk, rdv = tfa.flash_backward_dkv_reference(q, k, v, do, rlse, delta, bias, slopes,
                                                causal, scale)
    torch.cuda.synchronize()
    max_tol, l2_tol = KERNEL_TOL[dtype]
    lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    assert lse_err <= 1e-5, f"lse {lse_err:.3e}"
    for got, want, what in ((o, ro, "o"), (dq, rdq, "dq"), (dk, rdk, "dk"), (dv, rdv, "dv")):
        assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
        assert torch.isfinite(got.float()).all(), what
        err_max, err_l2 = kernel_errors(got, want)
        assert err_max <= max_tol and err_l2 <= l2_tol, \
            f"{what}: max {err_max:.3e} (tol {max_tol}), L2 {err_l2:.3e} (tol {l2_tol})"


@pytest.mark.cuda
def test_cuda_reads_the_models_qkv_views_by_stride(cuda_device):
    """q, k, v as the model hands them (views of one [B, S, 3E] product)
    give what contiguous copies give, bit for bit, with no copy made."""
    B, S, H = 2, 320, 12
    qkv = torch.randn(B, S, 3 * H * 64, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, 64) for t in qkv.split(H * 64, dim=-1))
    tfa.reset_counts()
    o, lse = tfa.flash_forward(q, k, v, *NO_EXTRAS)
    o2, lse2 = tfa.flash_forward(q.contiguous(), k.contiguous(), v.contiguous(), *NO_EXTRAS)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert tfa.flash_forward.launches == 2 and tfa.flash_forward_reference.calls == 0
    tfa.reset_counts()


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 64, 4, 80, device=cuda_device)
    with pytest.raises(NotImplementedError, match="Queue 2 part A"):
        tfa.flash_forward(q, q, q, *NO_EXTRAS)
    q = torch.zeros(1, 64, 4, 64, device=cuda_device)
    kv = torch.zeros(1, 64, 3, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_forward(q, kv, kv, *NO_EXTRAS)
    with pytest.raises(ValueError, match="multiple"):
        tattn.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="Queue 1 item 5"):
        tfa.flash_forward(q.half(), q.half(), q.half(), *NO_EXTRAS)
    padded = torch.zeros(1, 64, 4, 66, device=cuda_device)[..., :64]     # rows of 264 bytes
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_forward(padded, q, q, *NO_EXTRAS)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_forward(q, q.cpu(), q, *NO_EXTRAS)


# bf16 forward at peaked scores (q std 3, so the score std is ~3 as in
# chip_smoke.py): o against the plain forward computed in fp32 on the same
# bf16 inputs, by relative L2.  The kernel's own error there is bf16
# rounding of p and of o (2^-9 relative each, ~2e-3 together) and the
# ex2.approx exponentials (~2^-22 relative); a key tile lost or left
# unmasked moves o by percents.
PEAKED_L2_TOL = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "noncausal", "alibi", "bias-per-head",
                                  "ragged-s1000", "s129-causal", "d128-gqa4-s1000",
                                  "d128-alibi-s320"])
def test_cuda_forward_bf16_peaked(cuda_device, case):
    (q, k, v, _), bias, slopes, causal = kernel_inputs(case, "bfloat16", cuda_device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, _ = tfa.flash_forward(q, k, v, bias, slopes, causal, scale)
    ro, _ = tfa.flash_forward_reference(q.float(), k.float(), v.float(), bias, slopes, causal,
                                        scale)
    torch.cuda.synchronize()
    err = ((o.float() - ro).norm() / ro.norm()).item()
    assert err <= PEAKED_L2_TOL, f"relative L2 {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["causal", "alibi", "ragged-s1000", "d128-alibi-s320"])
def test_cuda_saved_lse_gives_the_plain_forwards_gradients(cuda_device, case, dtype):
    """The lse the kernel forward saves (for the backward and for remat) is
    in natural-log units: dQ and dKV given it agree with dQ and dKV given
    the plain forward's lse, within the kernels' tolerances."""
    (q, k, v, do), bias, slopes, causal = kernel_inputs(case, dtype, cuda_device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = tfa.flash_forward(q, k, v, bias, slopes, causal, scale)
    _, rlse = tfa.flash_forward_reference(q, k, v, bias, slopes, causal, scale)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    grads = [tfa.flash_block_bwd(q, k, v, do, stat, delta, bias, slopes, causal=causal,
                                 scale=scale) for stat in (lse, rlse)]
    torch.cuda.synchronize()
    max_tol, l2_tol = KERNEL_TOL[dtype]
    for got, want, what in zip(grads[0], grads[1], ("dq", "dk", "dv")):
        err_max, err_l2 = kernel_errors(got, want)
        assert err_max <= max_tol and err_l2 <= l2_tol, \
            f"{what}: max {err_max:.3e} (tol {max_tol}), L2 {err_l2:.3e} (tol {l2_tol})"


# --------------------------------------------------------------------------- #
# on the card at head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J): the forward
# (Q from shared memory at 256; one K and V buffer in fp32 at 256); dQ and
# dKV at those widths are held in tests/test_torch_wide_head_training.py
# --------------------------------------------------------------------------- #
SERVING_KERNEL_CASES = {
    # NeoX-20B's 64 heads and GPT-J's 16 at S 2048; a ragged S 200; GQA 4;
    # ALiBi; a dense bias without the causal mask; around the 64-row tiles
    "neox-d96-s2048": (1, 2048, 64, 64, True, None, False, 96),
    "gptj-d256-s2048": (1, 2048, 16, 16, True, None, False, 256),
    "d96-ragged-s200": (2, 200, 8, 8, True, None, False, 96),
    "d256-ragged-s200": (2, 200, 4, 4, True, None, False, 256),
    "d96-gqa4-s320": (1, 320, 8, 2, True, None, False, 96),
    "d256-gqa4-s320": (1, 320, 8, 2, True, None, False, 256),
    "d96-alibi-s256": (1, 256, 8, 8, True, None, True, 96),
    "d256-alibi-s256": (1, 256, 4, 4, True, None, True, 256),
    "d96-bias-noncausal-s129": (1, 129, 4, 4, False, "per-head", False, 96),
    "d256-bias-noncausal-s129": (1, 129, 2, 2, False, "per-head", False, 256),
    "d256-s65-causal": (2, 65, 2, 2, True, None, False, 256),
}
KERNEL_CASES_ALL = {**KERNEL_CASES, **SERVING_KERNEL_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SERVING_KERNEL_CASES))
def test_cuda_forward_at_head_dims_96_256_matches_plain(cuda_device, case, dtype):
    (q, k, v, _), bias, slopes, causal = kernel_inputs(case, dtype, cuda_device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    tfa.reset_counts()
    o, lse = tfa.flash_forward(q, k, v, bias, slopes, causal, scale)
    assert tfa.flash_forward.launches == 1
    ro, rlse = tfa.flash_forward_reference(q, k, v, bias, slopes, causal, scale)
    torch.cuda.synchronize()
    lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    assert lse_err <= 1e-5, f"lse {lse_err:.3e}"
    assert o.dtype == ro.dtype and o.shape == ro.shape and torch.isfinite(o.float()).all()
    max_tol, l2_tol = KERNEL_TOL[dtype]
    err_max, err_l2 = kernel_errors(o, ro)
    assert err_max <= max_tol and err_l2 <= l2_tol, \
        f"o: max {err_max:.3e} (tol {max_tol}), L2 {err_l2:.3e} (tol {l2_tol})"
    if dtype == "bfloat16":
        ro, _ = tfa.flash_forward_reference(q.float(), k.float(), v.float(), bias, slopes,
                                            causal, scale)
        err = ((o.float() - ro).norm() / ro.norm()).item()
        assert err <= PEAKED_L2_TOL, f"peaked relative L2 {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 256])
def test_cuda_gradients_at_head_dims_96_256_raise(cuda_device, D):
    """A gradient at head_dim 96 and 256 runs the kernels now; the width
    beside each that no kernel takes (80, 512) still raises naming Queue 2
    part A, before any forward, and so does the forward alone."""
    q = torch.randn(1, 320, 4, D, device=cuda_device, requires_grad=True)
    tfa.reset_counts()
    tattn.flash_attention(q, q, q).float().square().sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    assert (tfa.flash_backward_dq.launches, tfa.flash_backward_dkv.launches) == (1, 1)
    tfa.reset_counts()
    other = torch.randn(1, 320, 4, {96: 80, 256: 512}[D], device=cuda_device,
                        requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue 2 part A"):
        tattn.flash_attention(other, other, other)
    assert tfa.flash_forward.launches == 0
    with torch.no_grad(), pytest.raises(NotImplementedError, match="Queue 2 part A"):
        tattn.flash_attention(other, other, other)
