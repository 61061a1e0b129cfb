"""Parity of the port's block-sparse attention (``deepspeed_tpu_torch/ops/
sparse_attention/`` and ``ops/cuda/block_sparse_attention.py``) with the
JAX package's.

* Layouts: every mode at two or three parameter sets, seeds included,
  equal JAX's bit for bit; so do the LUTs of ``build_luts``, the exception
  types of ``sparsity_config_from_dict`` and the errors of
  ``SparseSelfAttention.get_layout``.
* Kernels: on the CPU the port's entry points run their plain versions.
  On the same numpy inputs they are held against JAX's Pallas kernels in
  interpret mode, as the JAX package's own tests run them: o and lse
  against ``_fwd``, and dq, dk, dv (the gradients of ``sum(o * do)``)
  against ``jax.grad`` through the Pallas ``block_sparse_attention``.
  Cases: causal and non-causal, blocks of 32 and 64, head_dim 32 and 64,
  2 to 12 heads, one layout per head, a layout with empty rows and one
  with a row that lists only a future block.  Tolerance: |port - jax| <=
  tol * max(1, |jax|), 1e-5 in fp32 (sums in other orders) and 1e-2 in
  bf16 (both sides compute in fp32 from the same bf16 inputs and round the
  outputs to bf16, so an element parts by at most one bf16 ulp, 2^-8 of
  its size, where the fp32 values straddle a rounding step).
* The masked-dense path (``sparse_reference_attention`` and the module
  with rpe, key-padding and attention masks in both modes) against JAX's,
  fp32, 1e-5.

* The forward's work list (``build_fwd_tasks``), on the same layouts:
  every live (head, query block, key block) once, as the plain version's
  ``_keep`` has it, the diagonal block marked, empty rows present with
  count 0, tasks longest first across heads, made once per layout.  dQ
  walks it too: a plain walk of each task's entries in order, masked by
  value only on a task's diagonal block, gives the plain dQ to fp32
  rounding on every ``CASES`` layout, and the op's backward hands dQ the
  forward's own list.
* dKV's work list (``build_dkv_tasks``), on every ``KERNEL_CASES`` layout
  and the training path's (fixed, S 4096, H 12), unsplit and split: every
  live (key block, query block) pair in exactly one task, no future pair
  under ``causal``, tasks longest first and none past the split length,
  distinct partial slots for the splits of one column.

The CUDA kernels run only on a card: the ``cuda``-marked tests skip here
and run on the GPU machine (``python -m pytest
tests/test_torch_sparse_attention.py -m cuda``), where each kernel is held
against its plain version (with the kernel's rounding) on the same inputs,
and dQ and dKV (whose split columns are summed by the last split to
arrive) must give bitwise-equal outputs call after call.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as tssa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #
# (mode, kwargs, seq_len)
LAYOUTS = [
    ("dense", dict(num_heads=3, block=32), 128),
    ("dense", dict(num_heads=2, block=64), 256),
    ("fixed", dict(num_heads=12, block=64, num_local_blocks=4, num_global_blocks=1,
                   attention="unidirectional"), 4096),
    ("fixed", dict(num_heads=4, block=16, num_local_blocks=4, attention="bidirectional",
                   horizontal_global_attention=True), 16 * 10),
    ("fixed", dict(num_heads=4, block=16, different_layout_per_head=True,
                   num_local_blocks=4, num_global_blocks=1,
                   num_different_global_patterns=4), 16 * 9),
    ("variable", dict(num_heads=2, block=16, num_random_blocks=2,
                      attention="unidirectional", seed=3), 16 * 8),
    ("variable", dict(num_heads=3, block=16, different_layout_per_head=True,
                      num_random_blocks=1, local_window_blocks=[2, 4],
                      global_block_indices=[0, 5], global_block_end_indices=[2, 7],
                      horizontal_global_attention=True, seed=11), 16 * 12),
    ("bigbird", dict(num_heads=2, block=16, num_random_blocks=2, seed=7), 16 * 8),
    ("bigbird", dict(num_heads=12, block=64, different_layout_per_head=True,
                     num_random_blocks=3, num_sliding_window_blocks=3, num_global_blocks=2,
                     seed=5), 64 * 32),
    ("bigbird", dict(num_heads=2, block=32, num_random_blocks=1,
                     attention="unidirectional", seed=9), 32 * 6),
    ("bslongformer", dict(num_heads=1, block=16, num_sliding_window_blocks=3,
                          global_block_indices=[0, 4]), 16 * 8),
    ("bslongformer", dict(num_heads=2, block=32, num_sliding_window_blocks=5,
                          global_block_indices=[0], global_block_end_indices=[2],
                          attention="unidirectional"), 32 * 10),
    ("local_sliding_window", dict(num_heads=2, block=16, num_sliding_window_blocks=3), 16 * 8),
    ("local_sliding_window", dict(num_heads=1, block=32, num_sliding_window_blocks=5,
                                  attention="bidirectional"), 32 * 9),
]
LAYOUT_IDS = [f"{mode}-{i}" for i, (mode, _, _) in enumerate(LAYOUTS)]


@pytest.mark.parametrize("mode,kw,seq", LAYOUTS, ids=LAYOUT_IDS)
def test_layout_equals_jax_bit_for_bit(mode, kw, seq):
    want = jsc.MODE_TO_CONFIG[mode](**kw).make_layout(seq)
    got = tsc.MODE_TO_CONFIG[mode](**kw).make_layout(seq)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    cfg = dict(kw, mode=mode)
    heads = cfg.pop("num_heads")
    from_dict = tsc.sparsity_config_from_dict(cfg, num_heads=heads).make_layout(seq)
    np.testing.assert_array_equal(from_dict, want)
    for a, b in zip(tbs.build_luts(got), jbs.build_luts(want)):
        np.testing.assert_array_equal(a, b)


def test_path_layout_keeps_640_of_2080_causal_block_pairs_per_head():
    layout = tsc.sparsity_config_from_dict(
        {"mode": "fixed", "block": 64, "num_local_blocks": 4, "num_global_blocks": 1,
         "attention": "unidirectional"}, num_heads=12).make_layout(4096)
    assert layout.shape == (12, 64, 64) and (layout.sum(axis=(1, 2)) == 640).all()
    row_lut, row_cnt, col_lut, col_cnt = tbs.build_luts(layout)
    assert row_lut.shape[1] == row_cnt.max() and col_lut.shape[1] == col_cnt.max() == 61


def test_luts_of_empty_rows_equal_jax():
    layout = np.zeros((2, 4, 4), np.int32)
    layout[0, :2, :2] = 1
    layout[1, 0, 2] = 1
    for a, b in zip(tbs.build_luts(layout), jbs.build_luts(layout)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg,exc", [
    ({"mode": "nope"}, NotImplementedError),
    ({"mode": "fixed", "blokc": 64}, TypeError),
    ({"mode": "fixed", "num_local_blocks": 4, "num_global_blocks": 3}, ValueError),
    ({"mode": "fixed", "attention": "sideways"}, NotImplementedError),
    ({"mode": "variable", "global_block_indices": [3], "global_block_end_indices": [2]},
     ValueError),
])
def test_sparsity_config_from_dict_raises_as_jax_does(cfg, exc):
    with pytest.raises(exc):
        jsc.sparsity_config_from_dict(cfg, num_heads=2)
    with pytest.raises(exc):
        tsc.sparsity_config_from_dict(cfg, num_heads=2)
    with pytest.raises(NotImplementedError):
        tsc.validate_sparsity_mode("nope")
    assert sorted(tsc.MODE_TO_CONFIG) == sorted(jsc.MODE_TO_CONFIG)


@pytest.mark.parametrize("seq,max_len", [(100, 512), (1024, 512), (4096, None), (256, 512)])
def test_get_layout_raises_as_jax_does(seq, max_len):
    """Not a multiple of the block, or past max_seq_length (2048 by default,
    so the seq-4096 path must pass max_seq_length=4096), raises ValueError
    in both packages; otherwise the sub-layouts are equal."""
    kw = {} if max_len is None else {"max_seq_length": max_len}
    mods = [pkg.SparseSelfAttention(pkg.FixedSparsityConfig(num_heads=2, block=64), **kw)
            for pkg in (jsa, tsa)]
    if seq % 64 or seq > (max_len or 2048):
        for mod in mods:
            with pytest.raises(ValueError):
                mod.get_layout(seq)
        return
    jl, tl = (mod.get_layout(seq) for mod in mods)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tl, mods[1].master_layout[:, :4, :4])
    with pytest.raises(ValueError):
        tsa.SparseSelfAttention(key_padding_mask_mode="xor")


# --------------------------------------------------------------------------- #
# kernels: plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #
def empty_rows_layout():
    layout = np.zeros((1, 4, 4), np.int32)
    layout[0, :2, :2] = 1                     # rows 2-3 attend nothing
    return layout


def future_only_layout():
    layout = np.zeros((1, 4, 4), np.int32)
    layout[0, 0, 2] = 1                       # row 0 attends only future block 2
    layout[0, 1:, :2] = 1
    return layout


# name: (B, S, H, D, layout (a function of H, S), causal)
CASES = {
    "fixed-causal": (2, 256, 2, 32, lambda H, S: tsc.FixedSparsityConfig(
        num_heads=H, block=64, num_local_blocks=2, attention="unidirectional").make_layout(S),
        True),
    "bigbird-noncausal": (2, 256, 2, 32, lambda H, S: tsc.BigBirdSparsityConfig(
        num_heads=H, block=64, seed=2).make_layout(S), False),
    "bslongformer-block32": (1, 128, 2, 32, lambda H, S: tsc.BSLongformerSparsityConfig(
        num_heads=H, block=32).make_layout(S), False),
    "per-head-variable": (1, 256, 4, 64, lambda H, S: tsc.VariableSparsityConfig(
        num_heads=H, block=32, different_layout_per_head=True, num_random_blocks=2,
        attention="unidirectional", seed=4).make_layout(S), True),
    "gpt2-heads": (1, 256, 12, 64, lambda H, S: tsc.FixedSparsityConfig(
        num_heads=H, block=64, num_local_blocks=2, attention="unidirectional").make_layout(S),
        True),
    "empty-rows": (1, 128, 1, 32, lambda H, S: empty_rows_layout(), False),
    "future-only": (1, 128, 1, 32, lambda H, S: future_only_layout(), True),
}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def make_case(name, seed=0):
    """numpy (q, k, v, do) in [B, S, H, D], the layout and causal."""
    B, S, H, D, layout_fn, causal = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    return (q, k, v, do), layout_fn(H, S), causal


def to_torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(DTYPES[dtype][1])


def assert_close(got, want, dtype, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= TOL[dtype], f"{what}: {err:.3e} > {TOL[dtype]}"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_pallas_fwd(case, dtype):
    (q, k, v, _), layout, causal = make_case(case)
    B, S, H, D = q.shape
    row_lut, row_cnt, _, _ = jbs.build_luts(layout)
    jt = [jnp.asarray(x, DTYPES[dtype][0]).transpose(0, 2, 1, 3) for x in (q, k, v)]
    jo, jlse = jbs._fwd(*jt, jnp.asarray(row_lut), jnp.asarray(row_cnt),
                        scale=1.0 / math.sqrt(D), causal=causal, bs=S // layout.shape[-1])
    luts = tbs.device_luts(layout, "cpu")
    o, lse = tbs.block_sparse_forward(*(to_torch(x, dtype) for x in (q, k, v)), luts[0],
                                      luts[1], causal, 1.0 / math.sqrt(D))
    assert o.dtype == DTYPES[dtype][1] and lse.dtype == torch.float32
    assert_close(o, jo.transpose(0, 2, 1, 3), dtype, "o")
    assert_close(lse, jlse[..., 0], dtype, "lse")
    if case in ("empty-rows", "future-only"):
        rows = slice(64, None) if case == "empty-rows" else slice(0, 32)
        assert (o[:, rows] == 0).all()
        assert (lse[:, :, rows] == -1e30).all() and (np.asarray(jlse)[:, :, rows] == -1e30).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_grad_of_pallas(case, dtype):
    """dq, dk, dv of ``sum(o * do)`` through the public functions."""
    (q, k, v, do), layout, causal = make_case(case, seed=1)
    jdt = DTYPES[dtype][0]
    jdo = jnp.asarray(do)
    jgrads = jax.grad(lambda *a: jnp.sum(jbs.block_sparse_attention(
        *a, layout, causal=causal).astype(jnp.float32) * jdo), argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    ts = [to_torch(x, dtype).requires_grad_() for x in (q, k, v)]
    o = tbs.block_sparse_attention(*ts, layout, causal=causal)
    (o.float() * torch.from_numpy(do)).sum().backward()
    for t, want, what in zip(ts, jgrads, ("dq", "dk", "dv")):
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()
        assert_close(t.grad, want, dtype, what)
    if case == "empty-rows":
        assert (ts[0].grad[:, 64:] == 0).all()
    if case == "future-only":
        assert (ts[0].grad[:, :32] == 0).all()


def test_kernel_rounding_is_the_identity_in_fp32_and_rounds_p_and_ds_in_bf16():
    (q, k, v, do), layout, causal = make_case("fixed-causal", seed=2)
    row_lut, row_cnt, col_lut, col_cnt = tbs.device_luts(layout, "cpu")
    for dtype in ("float32", "bfloat16"):
        tq, tk, tv, tdo = (to_torch(x, dtype) for x in (q, k, v, do))
        args = (tq, tk, tv, row_lut, row_cnt, causal, 0.125)
        o, lse = tbs.block_sparse_forward_reference(*args)
        o2, lse2 = tbs.block_sparse_forward_reference(*args, kernel_rounding=True)
        delta = (o.float() * tdo.float()).sum(-1).transpose(1, 2).contiguous()
        bargs = (tq, tk, tv, tdo, lse, delta, col_lut, col_cnt, causal, 0.125)
        dk, dv = tbs.block_sparse_backward_dkv_reference(*bargs)
        dk2, dv2 = tbs.block_sparse_backward_dkv_reference(*bargs, kernel_rounding=True)
        assert torch.equal(lse, lse2)
        same = dtype == "float32"
        assert torch.equal(o, o2) == same and torch.equal(dk, dk2) == same
        assert_close(o2, o.float().numpy(), dtype, "o with the kernel's rounding")
        assert_close(dv2, dv.float().numpy(), dtype, "dv with the kernel's rounding")


# --------------------------------------------------------------------------- #
# the masked-dense path and the module
# --------------------------------------------------------------------------- #
MASK_CASES = {
    "rpe": dict(rpe=True),
    "kp-add-am-mul": dict(kp="add", am="mul"),
    "kp-mul-am-add-causal": dict(kp="mul", am="add", causal=True),
    "all-mul-causal": dict(rpe=True, kp="mul", am="mul", causal=True),
}


def mask_inputs(seed=5, B=2, S=128, H=2, D=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    rpe = (rng.standard_normal((H, S, S)) * 0.5).astype(np.float32)
    kp = np.ones((B, S), np.float32)
    kp[:, 96:] = 0
    am = (rng.random((S, S)) > 0.2).astype(np.float32)
    return (q, k, v), rpe, kp, am


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_sparse_reference_attention_matches_jax(case):
    spec = MASK_CASES[case]
    (q, k, v), rpe, kp, am = mask_inputs()
    layout = tsc.BigBirdSparsityConfig(num_heads=2, block=32, seed=5).make_layout(128)
    kw = dict(causal=spec.get("causal", False),
              key_padding_mask_mode=spec.get("kp", "add"), attn_mask_mode=spec.get("am", "mul"))
    arrays = dict(rpe=rpe if spec.get("rpe") else None, key_padding_mask=kp if "kp" in spec
                  else None, attn_mask=am if "am" in spec else None)
    want = jbs.sparse_reference_attention(
        *(jnp.asarray(x) for x in (q, k, v)), layout,
        **{n: None if a is None else jnp.asarray(a) for n, a in arrays.items()}, **kw)
    got = tbs.sparse_reference_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), layout,
        **{n: None if a is None else torch.from_numpy(a) for n, a in arrays.items()}, **kw)
    assert_close(got, want, "float32", "o")


def test_module_paths_match_jax_and_warn_once(monkeypatch):
    warnings = []
    monkeypatch.setattr(tssa, "log_dist", lambda msg, **kw: warnings.append(msg))
    (q, k, v), rpe, kp, _ = mask_inputs(seed=6)
    mods = [pkg.SparseSelfAttention(pkg.BigBirdSparsityConfig(num_heads=2, block=32, seed=5),
                                    max_seq_length=256, key_padding_mask_mode="mul")
            for pkg in (jsa, tsa)]
    jq, tq = [jnp.asarray(x) for x in (q, k, v)], [torch.from_numpy(x) for x in (q, k, v)]
    assert_close(mods[1](*tq), mods[0](*jq), "float32", "fast path")
    for _ in range(2):
        got = mods[1](*tq, key_padding_mask=torch.from_numpy(kp))
    assert_close(got, mods[0](*jq, key_padding_mask=jnp.asarray(kp)), "float32", "mask path")
    assert len(warnings) == 1 and "masked-dense" in warnings[0]
    v2 = tq[2].clone()
    v2[:, 96:] = 123.0
    torch.testing.assert_close(mods[1](tq[0], tq[1], v2, key_padding_mask=torch.from_numpy(kp)),
                               got, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="share shape"):
        mods[1](tq[0], tq[1][:, :64], tq[2])


# --------------------------------------------------------------------------- #
# dispatch on the CPU, and what the kernels do not take
# --------------------------------------------------------------------------- #
def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    (q, k, v, _), layout, causal = make_case("gpt2-heads")
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tbs.reset_counts()
    tsa.block_sparse_attention(*ts, layout, causal=causal).sum().backward()
    assert (tbs.block_sparse_forward_reference.calls, tbs.block_sparse_backward_dq_reference.calls,
            tbs.block_sparse_backward_dkv_reference.calls) == (1, 1, 1)
    assert (tbs.block_sparse_forward.launches, tbs.block_sparse_backward_dq.launches,
            tbs.block_sparse_backward_dkv.launches) == (0, 0, 0)
    luts = tbs.device_luts(layout, "cpu")
    assert luts is tbs.device_luts(layout.copy(), torch.device("cpu"))     # one copy per layout
    assert all(t.dtype == torch.int32 for t in luts)
    tbs.reset_counts()


def test_what_the_kernels_do_not_take_raises():
    """Shapes are checked before the device, so meta tensors reach the
    checks a CUDA tensor meets."""
    def luts(H, nb):
        return (torch.zeros(H * nb, 1, dtype=torch.int32, device="meta"),
                torch.ones(H, nb, dtype=torch.int32, device="meta"))
    q = torch.empty(1, 256, 2, 32, device="meta")
    with pytest.raises(ValueError, match="head_dim 64.*Queue 1 item 9"):
        tbs.block_sparse_forward(q, q, q, *luts(2, 4), True, 0.125)
    q = torch.empty(1, 256, 2, 64, device="meta")
    with pytest.raises(ValueError, match="block 64.*Queue 1 item 9"):
        tbs.block_sparse_forward(q, q, q, *luts(2, 8), True, 0.125)
    with pytest.raises(TypeError, match="Queue 1 item 5"):
        tbs.block_sparse_forward(q.half(), q.half(), q.half(), *luts(2, 4), True, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        tbs.block_sparse_forward(q, q, q, *luts(2, 4), True, 0.125)
    with pytest.raises(ValueError, match="layout must be"):
        tbs.block_sparse_attention(torch.zeros(1, 64, 2, 8), torch.zeros(1, 64, 2, 8),
                                   torch.zeros(1, 64, 2, 8), np.ones((3, 2, 2)))
    with pytest.raises(ValueError, match="one shape"):
        tbs.block_sparse_attention(torch.zeros(1, 64, 2, 8), torch.zeros(1, 64, 1, 8),
                                   torch.zeros(1, 64, 1, 8), np.ones((2, 2, 2)))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# (B, S, H, layout, causal) at block 64 and head_dim 64
KERNEL_CASES = {
    "fixed-causal-s1024": (2, 1024, 4, lambda H, S: tsc.FixedSparsityConfig(
        num_heads=H, block=64, num_local_blocks=4, attention="unidirectional").make_layout(S),
        True),
    "bigbird-noncausal": (1, 1024, 4, lambda H, S: tsc.BigBirdSparsityConfig(
        num_heads=H, block=64, num_random_blocks=2, seed=3).make_layout(S), False),
    "per-head-variable": (1, 512, 4, lambda H, S: tsc.VariableSparsityConfig(
        num_heads=H, block=64, different_layout_per_head=True, num_random_blocks=2,
        attention="unidirectional", seed=4).make_layout(S), True),
    "empty-rows": (1, 256, 1, lambda H, S: empty_rows_layout(), False),
    "future-only": (1, 256, 1, lambda H, S: future_only_layout(), True),
    # the training path's layout at B 1, H 2: "auto" gives each block slot
    # a walk of about 5 tiles, so its longest columns (61 live query blocks)
    # split into 13 tasks, summed in the kernel
    "fixed-causal-s4096-split": (1, 4096, 2, lambda H, S: tsc.FixedSparsityConfig(
        num_heads=H, block=64, num_local_blocks=4, num_global_blocks=1,
        attention="unidirectional").make_layout(S), True),
}
# kernel against the plain version with the kernel's rounding, on the same
# inputs, q drawn so the score std is 3 (peaked rows).  Per output: max
# |err| / max |plain| and |err|_2 / |plain|_2.  fp32: sums in another
# order.  bf16: both round p, ds and the outputs to bf16 from fp32 values
# that differ by rounding noise, one ulp (2^-8) at most per element.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 5e-3)}


# --------------------------------------------------------------------------- #
# dKV's work list (host side, no card needed)
# --------------------------------------------------------------------------- #
WORK_LIST_CASES = dict(KERNEL_CASES, **{"gpt2-s4096-fixed": (
    2, 4096, 12, lambda H, S: tsc.sparsity_config_from_dict(
        {"mode": "fixed", "block": 64, "num_local_blocks": 4, "num_global_blocks": 1,
         "attention": "unidirectional"}, num_heads=H).make_layout(S), True)})
SPLITS = [None, 4, 16]


def work_list(case, split):
    """(tasks as dicts of TASK_FIELDS, entries, n_slots, n_counters, layout,
    causal) of one case."""
    _, S, H, layout_fn, causal = WORK_LIST_CASES[case]
    layout = layout_fn(H, S)
    _, _, col_lut, col_cnt = tbs.build_luts(layout)
    tasks, entries, n_slots, n_counters = tbs.build_dkv_tasks(col_lut, col_cnt, causal, split)
    assert tasks.dtype == entries.dtype == np.int32 and tasks.shape[1] == len(tbs.TASK_FIELDS)
    rows = [dict(zip(tbs.TASK_FIELDS, map(int, t))) for t in tasks]
    return rows, entries, n_slots, n_counters, layout, causal


@pytest.mark.parametrize("split", SPLITS, ids=str)
@pytest.mark.parametrize("case", sorted(WORK_LIST_CASES))
def test_dkv_tasks_cover_every_live_pair_once(case, split):
    """Each (head, key block, query block) the kernel must visit, the
    layout's listed pairs (under ``causal`` those with the query block at or
    after the key block), in exactly one task; every key block has a task,
    so a column with nothing live still writes its zeros."""
    rows, entries, _, _, layout, causal = work_list(case, split)
    H, nb, _ = layout.shape
    seen = np.zeros((H, nb, nb), np.int64)               # [h, query block, key block]
    for t in rows:
        for qb in entries[t["first"]:t["first"] + t["count"]]:
            seen[t["head"], qb, t["key_block"]] += 1
        assert list(entries[t["first"]:t["first"] + t["count"]]) == sorted(
            entries[t["first"]:t["first"] + t["count"]])
    want = layout.astype(np.int64)
    if causal:
        want = want * np.tril(np.ones((nb, nb), np.int64))[None]
        assert not np.triu(seen, 1).any(), "a future pair in the work list"
    np.testing.assert_array_equal(seen, want)
    assert {(t["head"], t["key_block"]) for t in rows} == {
        (h, kb) for h in range(H) for kb in range(nb)}
    assert sum(t["count"] for t in rows) == len(entries)


@pytest.mark.parametrize("split", SPLITS, ids=str)
@pytest.mark.parametrize("case", sorted(WORK_LIST_CASES))
def test_dkv_tasks_run_longest_first_and_within_the_split(case, split):
    rows, _, _, _, _, _ = work_list(case, split)
    counts = [t["count"] for t in rows]
    assert counts == sorted(counts, reverse=True)
    if split is not None:
        assert max(counts) <= split
    for t in rows:     # near-equal splits: a column's runs differ by at most one block
        assert t["splits"] == 1 or t["count"] >= max(
            u["count"] for u in rows if (u["head"], u["key_block"]) ==
            (t["head"], t["key_block"])) - 1


@pytest.mark.parametrize("split", SPLITS, ids=str)
@pytest.mark.parametrize("case", sorted(WORK_LIST_CASES))
def test_dkv_splits_of_a_column_take_distinct_slots(case, split):
    """A split column's tasks: splits 0..n-1 once each, consecutive partial
    slots from ``slot - split`` (distinct across columns) and one counter of
    its own; an unsplit one has neither."""
    rows, _, n_slots, n_counters, _, _ = work_list(case, split)
    columns = {}
    for t in rows:
        columns.setdefault((t["head"], t["key_block"]), []).append(t)
    slots, counters = [], []
    for tasks in columns.values():
        n = tasks[0]["splits"]
        assert sorted(t["split"] for t in tasks) == list(range(n))
        assert all(t["splits"] == n for t in tasks)
        if n == 1:
            assert (tasks[0]["slot"], tasks[0]["counter"]) == (-1, -1)
            continue
        assert {t["slot"] - t["split"] for t in tasks} == {min(t["slot"] for t in tasks)}
        assert len({t["counter"] for t in tasks}) == 1
        slots += [t["slot"] for t in tasks]
        counters.append(tasks[0]["counter"])
    assert sorted(slots) == list(range(n_slots))
    assert sorted(counters) == list(range(n_counters))
    if split == 16 and case in ("fixed-causal-s4096-split", "gpt2-s4096-fixed"):
        assert max(len(tasks) for tasks in columns.values()) >= 3


def test_dkv_work_is_made_once_per_layout_and_batch():
    _, S, H, layout_fn, causal = WORK_LIST_CASES["gpt2-s4096-fixed"]
    layout = layout_fn(H, S)
    work = tbs.dkv_work(layout, causal, 2, "cpu")
    assert work is tbs.dkv_work(layout.copy(), causal, 2, torch.device("cpu"))
    assert work is not tbs.dkv_work(layout, causal, 1, "cpu")
    # on the CPU "auto" splits nothing (the plain version walks the LUT)
    assert tbs.DKV_SPLIT == "auto" and tbs.dkv_split(layout, causal, 2, "cpu") is None
    assert tbs.dkv_work(layout, causal, 2, "cpu", split=16) is not work
    tasks, _, n_slots, n_counters = tbs.build_dkv_tasks(*tbs.build_luts(layout)[2:], causal,
                                                        None)
    assert torch.equal(work.tasks, torch.from_numpy(tasks))
    assert tuple(work.partials.shape) == (2, n_slots, 2, 64 * 64)
    assert tuple(work.counters.shape) == (2, n_counters) and not work.counters.any()
    assert work.workspace_bytes() == 4 * (work.partials.numel() + work.counters.numel())
    tbs._check_work(work, 2, H, S // 64, torch.device("cpu"))
    with pytest.raises(ValueError, match="work list"):
        tbs._check_work(None, 2, H, S // 64, torch.device("cpu"))
    with pytest.raises(ValueError, match="batch 1"):
        tbs._check_work(work, 1, H, S // 64, torch.device("cpu"))


# --------------------------------------------------------------------------- #
# the forward's work list (host side, no card needed)
# --------------------------------------------------------------------------- #
def fwd_list(case):
    """(tasks as dicts of FWD_TASK_FIELDS, entries, layout, causal, row LUT,
    row counts) of one case."""
    _, S, H, layout_fn, causal = WORK_LIST_CASES[case]
    layout = layout_fn(H, S)
    row_lut, row_cnt, _, _ = tbs.build_luts(layout)
    tasks, entries = tbs.build_fwd_tasks(row_lut, row_cnt, causal)
    assert tasks.dtype == entries.dtype == np.int32
    assert tasks.shape == (H * layout.shape[1], len(tbs.FWD_TASK_FIELDS))
    rows = [dict(zip(tbs.FWD_TASK_FIELDS, map(int, t))) for t in tasks]
    return rows, entries, layout, causal, row_lut, row_cnt


@pytest.mark.parametrize("case", sorted(WORK_LIST_CASES))
def test_fwd_tasks_cover_every_live_block_once_as_the_plain_version_keeps_it(case):
    """Each (head, query block, key block) whose score tile the plain
    version keeps any entry of (``_keep``: listed, and under ``causal`` not
    wholly in the future) is in exactly one task, ascending within it; the
    diagonal flag marks the tasks that end on their own block."""
    rows, entries, layout, causal, row_lut, row_cnt = fwd_list(case)
    H, nb, _ = layout.shape
    keep = tbs._keep(torch.from_numpy(row_lut), torch.from_numpy(row_cnt), causal, 64, False)
    want = np.zeros((H, nb, nb), np.int64)
    idx = row_lut.reshape(H, nb, -1)
    live = keep.flatten(3).any(-1).numpy()                 # [H, nb, n]
    for h, qb, j in zip(*np.nonzero(live)):
        want[h, qb, idx[h, qb, j]] += 1
    seen = np.zeros((H, nb, nb), np.int64)
    for t in rows:
        walk = list(entries[t["first"]:t["first"] + t["count"]])
        assert walk == sorted(walk)
        for kb in walk:
            seen[t["head"], t["query_block"], kb] += 1
        assert t["diagonal"] == int(causal and bool(walk) and walk[-1] == t["query_block"])
    np.testing.assert_array_equal(seen, want)
    assert sum(t["count"] for t in rows) == len(entries)


@pytest.mark.parametrize("case", sorted(WORK_LIST_CASES))
def test_fwd_tasks_keep_empty_rows_and_run_longest_first(case):
    """Every (head, query block) has one task, a row with nothing live
    among them with count 0 (it still writes o = 0 and lse = -1e30); the
    tasks come longest first across heads, ties by head then query
    block."""
    rows, _, layout, causal, _, _ = fwd_list(case)
    H, nb, _ = layout.shape
    assert sorted((t["head"], t["query_block"]) for t in rows) == [
        (h, qb) for h in range(H) for qb in range(nb)]
    live = layout * np.tril(np.ones((nb, nb), layout.dtype))[None] if causal else layout
    by_row = {(t["head"], t["query_block"]): t["count"] for t in rows}
    assert all(by_row[h, qb] == live[h, qb].sum() for h in range(H) for qb in range(nb))
    keys = [(-t["count"], t["head"], t["query_block"]) for t in rows]
    assert keys == sorted(keys)
    if case in ("empty-rows", "future-only"):
        assert rows[-1]["count"] == 0


def test_fwd_work_is_made_once_per_layout():
    _, S, H, layout_fn, causal = WORK_LIST_CASES["gpt2-s4096-fixed"]
    layout = layout_fn(H, S)
    work = tbs.fwd_work(layout, causal, "cpu")
    assert work is tbs.fwd_work(layout.copy(), causal, torch.device("cpu"))
    assert work is not tbs.fwd_work(layout, not causal, "cpu")
    tasks, entries = tbs.build_fwd_tasks(*tbs.build_luts(layout)[:2], causal)
    assert torch.equal(work.tasks, torch.from_numpy(tasks))
    assert torch.equal(work.entries, torch.from_numpy(entries))
    assert int(work.tasks[0, 3]) == 19                     # the path's longest causal row
    tbs._check_fwd_work(work, H, S // 64, torch.device("cpu"))
    with pytest.raises(ValueError, match="work list"):
        tbs._check_fwd_work(None, H, S // 64, torch.device("cpu"))
    with pytest.raises(ValueError, match="fwd_work of this layout"):
        tbs._check_fwd_work(work, H + 1, S // 64, torch.device("cpu"))


def walk_dq(q, k, v, do, lse, delta, work: "tbs.FwdWork", nb: int, scale: float):
    """dq by a plain walk of the forward's work list, as the dQ kernel
    walks it: per task, its entries in order, each a [bs, bs] score tile,
    masked by value (keys past the query) only on the last block of a task
    marked diagonal."""
    B, S, H, D = q.shape
    bs = S // nb
    qb, kb, vb, dob = (tbs._blocks(t, nb) for t in (q, k, v, do))       # [B, H, nb, bs, D]
    lse_b, delta_b = (t.reshape(B, H, nb, bs, 1) for t in (lse, delta))
    future = torch.arange(bs)[None, :] > torch.arange(bs)[:, None]      # [row, key]
    dq = torch.zeros(B, H, nb, bs, D)
    for h, row, first, count, diagonal in work.tasks.tolist():
        for it, col in enumerate(work.entries[first:first + count].tolist()):
            s = torch.einsum("brd,bcd->brc", qb[:, h, row], kb[:, h, col]) * scale
            if diagonal and it == count - 1:
                s = s.masked_fill(future, -math.inf)
            p = torch.exp(s - lse_b[:, h, row])
            dp = torch.einsum("brd,bcd->brc", dob[:, h, row], vb[:, h, col])
            ds = p * (dp - delta_b[:, h, row]) * scale
            dq[:, h, row] += torch.einsum("brc,bcd->brd", ds, kb[:, h, col])
    return tbs._unblock(dq, q.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dq_walk_of_the_fwd_work_list_gives_the_plain_dq(case):
    """Every ``CASES`` layout (empty rows, a future-only row, one layout per
    head, bidirectional bigbird, blocks of 32 and 64): the walk of the
    forward's work list equals the plain dQ (which the Pallas tests hold
    against JAX) to fp32 rounding."""
    (q, k, v, do), layout, causal = make_case(case, seed=3)
    nb = layout.shape[-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, "cpu")
    o, lse = tbs.block_sparse_forward_reference(tq, tk, tv, row_lut, row_cnt, causal, scale)
    delta = (o * tdo).sum(-1).transpose(1, 2).contiguous()
    want = tbs.block_sparse_backward_dq_reference(tq, tk, tv, tdo, lse, delta, row_lut, row_cnt,
                                                  causal, scale)
    got = walk_dq(tq, tk, tv, tdo, lse, delta, tbs.fwd_work(layout, causal, "cpu"), nb, scale)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_op_backward_hands_dq_the_forwards_work_list(monkeypatch, causal):
    """On CPU tensors the custom op's backward passes dQ the forward's own
    ``FwdWork`` (the tensors of ``fwd_work`` for this layout and
    ``causal``), as it passes dKV its ``DkvWork``."""
    (q, k, v, _), layout, _ = make_case("fixed-causal")
    seen = []
    plain_dq = tbs.block_sparse_backward_dq

    def recording_dq(*args, work=None):
        seen.append(work)
        return plain_dq(*args, work=work)
    monkeypatch.setattr(tbs, "block_sparse_backward_dq", recording_dq)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tbs.block_sparse_attention(*ts, layout, causal=causal).sum().backward()
    assert len(seen) == 1 and isinstance(seen[0], tbs.FwdWork)
    want, other = (tbs.fwd_work(layout, c, "cpu") for c in (causal, not causal))
    for got_t, want_t in zip(seen[0], want):
        assert got_t.data_ptr() == want_t.data_ptr() and torch.equal(got_t, want_t)
    assert not torch.equal(seen[0].tasks, other.tasks)      # the diagonal flags differ


@pytest.mark.parametrize("tiles,batch,slots,want", [
    (640 * 12, 2, 264, 59), (640 * 2, 1, 264, 5), (9, 1, 264, 1), (0, 1, 264, 1),
    (264, 1, 264, 1), (265, 1, 264, 2)])
def test_balanced_split_shares_the_tiles_among_the_block_slots(tiles, batch, slots, want):
    """"auto"'s split length: the training path's layout (640 live tiles a
    head, H 12, B 2) over 132 SMs x 2 blocks gives 59, so only its 61-tile
    columns split; at B 1, H 2 every column past 5 does."""
    assert tbs.balanced_split(tiles, batch, slots) == want
    if tiles:
        assert tbs.balanced_split(tiles, batch, slots) * slots >= tiles * batch


def kernel_inputs(case, dtype, device, seed=11):
    B, S, H, layout_fn, causal = KERNEL_CASES[case]
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, DTYPES[dtype][1])
    q = dev(rng.standard_normal((B, S, H, 64)) * 3.0)
    k, v, do = (dev(rng.standard_normal((B, S, H, 64))) for _ in range(3))
    return (q, k, v, do), layout_fn(H, S), causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_kernels_match_plain(cuda_device, case, dtype):
    (q, k, v, do), layout, causal = kernel_inputs(case, dtype, cuda_device)
    row_lut, row_cnt, col_lut, col_cnt = tbs.device_luts(layout, cuda_device)
    o, lse = tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, causal, 0.125,
                                      work=tbs.fwd_work(layout, causal, cuda_device))
    ro, rlse = tbs.block_sparse_forward_reference(q, k, v, row_lut, row_cnt, causal, 0.125,
                                                  kernel_rounding=True)
    delta = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, do, rlse, delta)
    dq = tbs.block_sparse_backward_dq(*bargs, row_lut, row_cnt, causal, 0.125,
                                      work=tbs.fwd_work(layout, causal, cuda_device))
    rdq = tbs.block_sparse_backward_dq_reference(*bargs, row_lut, row_cnt, causal, 0.125,
                                                 kernel_rounding=True)
    work = tbs.dkv_work(layout, causal, q.shape[0], cuda_device, q.dtype)
    dk, dv = tbs.block_sparse_backward_dkv(*bargs, col_lut, col_cnt, causal, 0.125, work=work)
    rdk, rdv = tbs.block_sparse_backward_dkv_reference(*bargs, col_lut, col_cnt, causal, 0.125,
                                                       kernel_rounding=True)
    torch.cuda.synchronize()
    lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    assert lse_err <= 1e-5, f"lse {lse_err:.3e}"
    max_tol, l2_tol = KERNEL_TOL[dtype]
    for got, want, what in ((o, ro, "o"), (dq, rdq, "dq"), (dk, rdk, "dk"), (dv, rdv, "dv")):
        assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
        assert torch.isfinite(got.float()).all(), what
        err = got.float() - want.float()
        scale = want.float().abs().max().clamp(min=1e-30)
        err_max = (err.abs().max() / scale).item()
        err_l2 = (err.norm() / want.float().norm().clamp(min=1e-30)).item()
        assert err_max <= max_tol and err_l2 <= l2_tol, \
            f"{what}: max {err_max:.3e} (tol {max_tol}), L2 {err_l2:.3e} (tol {l2_tol})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_dkv_is_deterministic_across_calls(cuda_device, dtype):
    """dKV twice on the same inputs, with a call at another shape between:
    bitwise-equal dK and dV.  The split columns' partials are summed in
    split order whatever the order of arrival, and each launch leaves its
    arrival counters at 0 for the next."""
    def dkv(case):
        (q, k, v, do), layout, causal = kernel_inputs(case, dtype, cuda_device)
        row_lut, row_cnt, col_lut, col_cnt = tbs.device_luts(layout, cuda_device)
        o, lse = tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, causal, 0.125,
                                          work=tbs.fwd_work(layout, causal, cuda_device))
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        work = tbs.dkv_work(layout, causal, q.shape[0], cuda_device, q.dtype)
        return tbs.block_sparse_backward_dkv(q, k, v, do, lse, delta, col_lut, col_cnt, causal,
                                             0.125, work=work)
    first = dkv("fixed-causal-s4096-split")
    other = dkv("fixed-causal-s1024")
    second = dkv("fixed-causal-s4096-split")
    torch.cuda.synchronize()
    for a, b, what in zip(first, second, ("dk", "dv")):
        assert torch.isfinite(a.float()).all(), what
        assert torch.equal(a, b), f"{what} differs between two calls on the same inputs"
    assert all(torch.isfinite(t.float()).all() for t in other)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_dq_is_deterministic_across_calls(cuda_device, dtype):
    """dQ twice on the same inputs, with a call at another shape between:
    bitwise-equal dq (each row is written by one block, no atomics)."""
    def dq(case):
        (q, k, v, do), layout, causal = kernel_inputs(case, dtype, cuda_device)
        row_lut, row_cnt, _, _ = tbs.device_luts(layout, cuda_device)
        work = tbs.fwd_work(layout, causal, cuda_device)
        o, lse = tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, causal, 0.125, work=work)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        return tbs.block_sparse_backward_dq(q, k, v, do, lse, delta, row_lut, row_cnt, causal,
                                            0.125, work=work)
    first = dq("fixed-causal-s4096-split")
    other = dq("bigbird-noncausal")
    second = dq("fixed-causal-s4096-split")
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all() and torch.isfinite(other.float()).all()
    assert torch.equal(first, second), "dq differs between two calls on the same inputs"


@pytest.mark.cuda
def test_cuda_dq_raises_without_its_work_list(cuda_device):
    (q, k, v, do), layout, causal = kernel_inputs("fixed-causal-s1024", "float32", cuda_device)
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, cuda_device)
    stats = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda_device)
    tbs.reset_counts()
    with pytest.raises(ValueError, match="block_sparse_backward_dq: the CUDA kernel walks a "
                                         "work list"):
        tbs.block_sparse_backward_dq(q, k, v, do, stats, stats, row_lut, row_cnt, causal, 0.125)
    other = tbs.fwd_work(np.ones((2, 16, 16), np.int32), causal, cuda_device)
    with pytest.raises(ValueError, match="fwd_work of this layout"):
        tbs.block_sparse_backward_dq(q, k, v, do, stats, stats, row_lut, row_cnt, causal, 0.125,
                                     work=other)
    assert tbs.block_sparse_backward_dq.launches == 0
    assert tbs.block_sparse_backward_dq_reference.calls == 0


@pytest.mark.cuda
def test_cuda_dkv_raises_without_its_work_list(cuda_device):
    (q, k, v, do), layout, causal = kernel_inputs("fixed-causal-s1024", "float32", cuda_device)
    _, _, col_lut, col_cnt = tbs.device_luts(layout, cuda_device)
    stats = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda_device)
    with pytest.raises(ValueError, match="work list"):
        tbs.block_sparse_backward_dkv(q, k, v, do, stats, stats, col_lut, col_cnt, causal, 0.125)
    with pytest.raises(ValueError, match="batch 2"):
        tbs.block_sparse_backward_dkv(q, k, v, do, stats, stats, col_lut, col_cnt, causal, 0.125,
                                      work=tbs.dkv_work(layout, causal, 1, cuda_device, q.dtype))


@pytest.mark.cuda
def test_cuda_reads_the_models_qkv_views_by_stride(cuda_device):
    """q, k, v as the model hands them (views of one [B, S, 3E] product)
    give what contiguous copies give, bit for bit."""
    B, S, H = 2, 512, 12
    qkv = torch.randn(B, S, 3 * H * 64, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, 64) for t in qkv.split(H * 64, dim=-1))
    layout = tsc.FixedSparsityConfig(num_heads=H, block=64,
                                     attention="unidirectional").make_layout(S)
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, cuda_device)
    work = tbs.fwd_work(layout, True, cuda_device)
    tbs.reset_counts()
    o, lse = tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, True, 0.125, work=work)
    o2, lse2 = tbs.block_sparse_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                                        row_lut, row_cnt, True, 0.125, work=work)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert tbs.block_sparse_forward.launches == 2
    assert tbs.block_sparse_forward_reference.calls == 0
    tbs.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_forward_reads_strided_qkv_views(cuda_device, case, dtype):
    """The forward on q, k and v as views of one [B, S, 3, H, 64] product
    (the model's qkv layout) gives, bit for bit, what contiguous copies
    give, and both agree with the plain version."""
    (q, k, v, _), layout, causal = kernel_inputs(case, dtype, cuda_device)
    qkv = torch.stack((q, k, v), dim=2)                     # [B, S, 3, H, 64]
    views = qkv.unbind(2)
    assert not views[0].is_contiguous()
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, cuda_device)
    work = tbs.fwd_work(layout, causal, cuda_device)
    o, lse = tbs.block_sparse_forward(*views, row_lut, row_cnt, causal, 0.125, work=work)
    o2, lse2 = tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, causal, 0.125, work=work)
    ro, rlse = tbs.block_sparse_forward_reference(q, k, v, row_lut, row_cnt, causal, 0.125,
                                                  kernel_rounding=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item() <= 1e-5
    max_tol, l2_tol = KERNEL_TOL[dtype]
    err = o.float() - ro.float()
    assert (err.abs().max() / ro.float().abs().max().clamp(min=1e-30)).item() <= max_tol
    assert (err.norm() / ro.float().norm().clamp(min=1e-30)).item() <= l2_tol


@pytest.mark.cuda
def test_cuda_forward_raises_without_its_work_list(cuda_device):
    (q, k, v, _), layout, causal = kernel_inputs("fixed-causal-s1024", "float32", cuda_device)
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, cuda_device)
    with pytest.raises(ValueError, match="work list"):
        tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, causal, 0.125)
    other = tbs.fwd_work(np.ones((2, 16, 16), np.int32), causal, cuda_device)
    with pytest.raises(ValueError, match="fwd_work of this layout"):
        tbs.block_sparse_forward(q, k, v, row_lut, row_cnt, causal, 0.125, work=other)


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(cuda_device):
    layout = np.ones((2, 4, 4), np.int32)
    q = torch.zeros(1, 128, 2, 64, device=cuda_device)
    luts = tbs.device_luts(layout, cuda_device)
    with pytest.raises(ValueError, match="block 64"):
        tbs.block_sparse_forward(q, q, q, luts[0], luts[1], False, 0.125)
    q = torch.zeros(1, 256, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 64"):
        tbs.block_sparse_forward(q, q, q, luts[0], luts[1], False, 0.125)
    q = torch.zeros(1, 256, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="Queue 1 item 5"):
        tbs.block_sparse_forward(q.half(), q.half(), q.half(), luts[0], luts[1], False, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        tbs.block_sparse_forward(q, q.cpu(), q, luts[0], luts[1], False, 0.125)


@pytest.mark.cuda
def test_cuda_module_launches_the_kernels_forward_and_backward(cuda_device):
    """``SparseSelfAttention`` on the card runs the three kernels, never
    their plain versions, with finite gradients."""
    mod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(num_heads=4, block=64,
                                                          attention="unidirectional"),
                                  max_seq_length=1024)
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 1024, 4, 64)).astype(np.float32))
               .to(cuda_device, torch.bfloat16).requires_grad_() for _ in range(3))
    tbs.reset_counts()
    mod(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tbs.block_sparse_forward.launches, tbs.block_sparse_backward_dq.launches,
            tbs.block_sparse_backward_dkv.launches) == (1, 1, 1)
    assert (tbs.block_sparse_forward_reference.calls, tbs.block_sparse_backward_dq_reference.calls,
            tbs.block_sparse_backward_dkv_reference.calls) == (0, 0, 0)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    tbs.reset_counts()
