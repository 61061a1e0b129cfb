"""Parity of the port's fused cross-entropy (``deepspeed_tpu_torch/ops/cuda/
cross_entropy.py``, and the chunked path of ``models/gpt.py``) with the JAX
package's.

On the CPU the port's ``cross_entropy`` runs its plain versions (forward,
dx, dhead); they are held against JAX's Pallas kernels in interpret mode
(``fused_cross_entropy``) and against JAX's ``chunked_cross_entropy`` with
the kernel off, on the same numpy inputs: N = 37 rows (ragged against any
row tile), E = 64, V = 384 with ``vocab_size`` 300 (padded columns
masked) and with ``vocab_size`` = V (no mask), and the same rows at E =
200 ("wide-ragged": not a multiple of the forward's 32- or 64-column
steps, one block of the backward's cluster).

The head bias (GPT-J's untied head) the same way: the loss and the
gradients of x, head and the bias against the Pallas kernels in interpret
mode (``has_bias``) and against JAX's chunked path, unchunked and in 3 row
chunks.

Tolerances.  fp32: the loss within 1e-6 relative, dx and dhead within
1e-5 of their largest magnitude (both sides sum in fp32, in other orders).
bf16: 2e-2 of the largest magnitude (the plain version rounds the logits
and ds to bf16 as JAX's unchunked branch does; the kernels keep them in
fp32).

The CUDA kernels run only on a card: the ``cuda``-marked tests skip here
and run on the GPU machine (``python -m pytest
tests/test_torch_cross_entropy.py -m cuda``); ``chip_smoke.py`` holds the
kernels against the plain versions at GPT-2's training shape and at
Llama-3-8B's and BLOOM-7b1's (n_embd 4096, through the wide backward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.pallas import cross_entropy as jce
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops.cuda import cross_entropy as tce

# (N, E, V, vocab_size)
CASES = {"padded-vocab": (37, 64, 384, 300), "full-vocab": (37, 64, 384, 384),
         "wide-ragged": (37, 200, 384, 300)}
GPT2_EMBD = {"gpt2": 768, "gpt2-medium": 1024, "gpt2-large": 1280, "gpt2-xl": 1600}
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2e-2, 2e-2)}   # (loss rtol, grad tol)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def make_inputs(N, E, V, vocab_size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, E)).astype(np.float32)
    head = (rng.standard_normal((V, E)) * 0.2).astype(np.float32)
    labels = rng.integers(0, vocab_size, N).astype(np.int32)
    return x, head, labels


def jax_value_and_grads(fn, x, head, dtype):
    jdt = DTYPES[dtype][0]
    loss, (dx, dh) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(x, jdt), jnp.asarray(head, jdt))
    return (float(loss), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dh.astype(jnp.float32)))


def port_value_and_grads(fn, x, head, dtype):
    tdt = DTYPES[dtype][1]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    ht = torch.from_numpy(head).to(tdt).requires_grad_()
    loss = fn(xt, ht)
    loss.backward()
    return float(loss.detach()), xt.grad.float().numpy(), ht.grad.float().numpy()


def assert_close(port, ref, dtype):
    loss_rtol, grad_tol = TOL[dtype]
    assert abs(port[0] - ref[0]) <= loss_rtol * abs(ref[0]), (port[0], ref[0])
    for p, r in zip(port[1:], ref[1:]):
        np.testing.assert_allclose(p, r, rtol=0, atol=grad_tol * np.abs(r).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_entropy_matches_pallas_interpret(case, dtype):
    """The JAX kernels themselves (interpret mode on the CPU)."""
    N, E, V, vocab = CASES[case]
    x, head, labels = make_inputs(N, E, V, vocab)
    lab_j, lab_t = jnp.asarray(labels), torch.from_numpy(labels)
    ref = jax_value_and_grads(
        lambda a, h: jce.fused_cross_entropy(a, h, lab_j, vocab), x, head, dtype)
    port = port_value_and_grads(
        lambda a, h: tce.cross_entropy(a, h, lab_t, vocab), x, head, dtype)
    assert_close(port, ref, dtype)


@pytest.mark.parametrize("n_chunks", [0, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_entropy_matches_jax_chunked(monkeypatch, case, dtype, n_chunks):
    """JAX's chunked_cross_entropy with the kernel off, against the port's
    fused function (n_chunks 0: JAX's unchunked branch) and the port's own
    chunked path (n_chunks 3: ragged row chunks, padding masked)."""
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    N, E, V, vocab = CASES[case]
    x, head, labels = make_inputs(N, E, V, vocab, seed=1)
    lab_j, lab_t = jnp.asarray(labels)[None], torch.from_numpy(labels)[None]
    ref = jax_value_and_grads(
        lambda a, h: jgpt.chunked_cross_entropy(a[None], h, lab_j, vocab, n_chunks=n_chunks),
        x, head, dtype)
    if n_chunks:
        fn = lambda a, h: tgpt.chunked_cross_entropy(a[None], h, lab_t, vocab, n_chunks=n_chunks)
    else:
        fn = lambda a, h: tce.cross_entropy(a, h, lab_t[0], vocab)
    assert_close(port_value_and_grads(fn, x, head, dtype), ref, dtype)


def make_bias(V, seed=0):
    return (np.random.default_rng(seed).standard_normal(V) * 0.5).astype(np.float32)


def jax_value_and_grads_with_bias(fn, x, head, b, dtype):
    jdt = DTYPES[dtype][0]
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(x, jdt), jnp.asarray(head, jdt), jnp.asarray(b, jdt))
    return (float(loss),) + tuple(np.asarray(g.astype(jnp.float32)) for g in grads)


def port_value_and_grads_with_bias(fn, x, head, b, dtype):
    tdt = DTYPES[dtype][1]
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, head, b)]
    loss = fn(*ts)
    loss.backward()
    return (float(loss.detach()),) + tuple(t.grad.float().numpy() for t in ts)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_entropy_with_head_bias_matches_pallas_interpret(case, dtype):
    """The JAX kernels with ``has_bias`` (interpret mode on the CPU): the
    loss and the gradients of x, head and the bias."""
    N, E, V, vocab = CASES[case]
    x, head, labels = make_inputs(N, E, V, vocab, seed=7)
    b = make_bias(V, seed=7)
    lab_j, lab_t = jnp.asarray(labels), torch.from_numpy(labels)
    ref = jax_value_and_grads_with_bias(
        lambda a, h, hb: jce.fused_cross_entropy(a, h, lab_j, vocab, head_b=hb), x, head, b,
        dtype)
    port = port_value_and_grads_with_bias(
        lambda a, h, hb: tce.cross_entropy(a, h, lab_t, vocab, head_b=hb), x, head, b, dtype)
    assert_close(port, ref, dtype)


@pytest.mark.parametrize("n_chunks", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_entropy_with_head_bias_matches_jax_chunked(monkeypatch, case, n_chunks):
    """JAX's chunked_cross_entropy with ``head_b`` and the kernel off
    against the port's (fp32): unchunked, and in 3 ragged row chunks."""
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    N, E, V, vocab = CASES[case]
    x, head, labels = make_inputs(N, E, V, vocab, seed=8)
    b = make_bias(V, seed=8)
    lab_j, lab_t = jnp.asarray(labels)[None], torch.from_numpy(labels)[None]
    ref = jax_value_and_grads_with_bias(
        lambda a, h, hb: jgpt.chunked_cross_entropy(a[None], h, lab_j, vocab,
                                                    n_chunks=n_chunks, head_b=hb),
        x, head, b, "float32")
    port = port_value_and_grads_with_bias(
        lambda a, h, hb: tgpt.chunked_cross_entropy(a[None], h, lab_t, vocab,
                                                    n_chunks=n_chunks, head_b=hb),
        x, head, b, "float32")
    assert_close(port, ref, "float32")


def test_plain_entry_points_agree_with_autograd_of_the_logits():
    """The hand-derived dx and dhead are autograd's gradient of the
    unchunked loss (fp32, 1e-6 of the largest magnitude)."""
    N, E, V, vocab = CASES["padded-vocab"]
    x, head, labels = map(torch.from_numpy, make_inputs(N, E, V, vocab, seed=2))
    xg, hg = x.clone().requires_grad_(), head.clone().requires_grad_()
    logits = tce.ce_logits(xg, hg, vocab)
    (torch.logsumexp(logits, -1) - tce.label_logit(logits, labels)).mean().backward()
    nll, lse = tce.ce_forward(x, head, labels, vocab)
    g = torch.full((1,), 1.0 / N)
    dx = tce.ce_backward_dx(x, head, labels, lse, g, vocab)
    dh = tce.ce_backward_dhead(x, head, labels, lse, g, vocab)
    for got, want in ((dx, xg.grad), (dh, hg.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tce.reset_counts()
    x, head, labels = map(torch.from_numpy, make_inputs(*CASES["full-vocab"]))
    x.requires_grad_()
    tce.cross_entropy(x, head, labels, 384).backward()
    assert (tce.ce_forward.launches, tce.ce_backward_dx.launches,
            tce.ce_backward_dhead.launches) == (0, 0, 0)
    assert tce.ce_forward_reference.calls == 1
    assert tce.ce_backward_dx_reference.calls == 1
    assert tce.ce_backward_dhead_reference.calls == 0     # head needs no grad
    tce.reset_counts()


def test_other_devices_raise_and_a_bias_is_taken():
    """A device with no kernel raises; a head bias is taken (on the CPU by
    the plain versions, which give its gradient as dhead's entry point
    does)."""
    x = torch.empty(4, 768, device="meta")
    lab = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tce.ce_forward(x, x, lab, 4)
    N, E, V, vocab = CASES["padded-vocab"]
    x, head, labels = map(torch.from_numpy, make_inputs(N, E, V, vocab, seed=9))
    b = torch.from_numpy(make_bias(V, seed=9)).requires_grad_()
    tce.reset_counts()
    tce.cross_entropy(x, head, labels, vocab, head_b=b).backward()
    assert b.grad is not None and torch.isfinite(b.grad).all()
    assert tce.ce_backward_dhead_reference.calls == 1 and tce.ce_backward_dhead.launches == 0
    assert b.grad[vocab:].abs().max() == 0          # pad columns take no weight
    tce.reset_counts()


def _meta_inputs(E, N=4, V=128):
    x = torch.empty(N, E, device="meta")
    head = torch.empty(V, E, device="meta")
    return x, head, torch.empty(N, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("E", sorted(GPT2_EMBD.values()) + [200, 1672, 4096])
def test_kernel_shape_check_takes_every_gpt2_width(E):
    """The kernels' shape check takes each GPT-2 preset's n_embd (and 200,
    not a multiple of the forward's 32-column step), and the widths past
    the cluster backward's 8 x 208 columns: 1672, and LLaMA's and BLOOM's
    4096, which take the wide backward."""
    x, head, labels = _meta_inputs(E)
    assert tce._check_cuda("ce_forward", x, head, labels, 128) == 0
    assert tce.wide_path(E) == (E > tce.CLUSTER_MAX_EMBD)
    if E in GPT2_EMBD.values():
        assert tgpt.gpt_config(next(k for k, v in GPT2_EMBD.items() if v == E)).n_embd == E


@pytest.mark.parametrize("E", [100, 764, 1604, 4100])
def test_kernel_shape_check_refuses_other_widths_naming_the_roadmap(E):
    """A width that is not a multiple of 8 raises, naming the ROADMAP item;
    it never falls back."""
    x, head, labels = _meta_inputs(E)
    with pytest.raises(ValueError, match="n_embd.*Queue 1: other GPT families"):
        tce._check_cuda("ce_forward", x, head, labels, 128)


def test_dx_grid_splits_the_vocab_to_fill_the_waves():
    """GPT-2's dx at N 4096: 32 clusters in one wave when the card holds
    them all (no vocab split); when it holds 25 at once the vocab splits
    so that the waves come out nearly even; a few rows split the vocab to
    use the card, every split non-empty."""
    assert tce.dx_grid(4096, 50304, torch.bfloat16, 32) == (32, 1)
    tiles, splits = tce.dx_grid(4096, 50304, torch.bfloat16, 25)
    per_split = -(-786 // splits)
    assert tiles == 32 and 1 < splits <= 16
    assert -(-32 * splits // 25) * per_split < 2 * 786           # better than two whole waves
    tiles, splits = tce.dx_grid(37, 1000, torch.float32, 100)
    v_tiles = -(-1000 // tce.BWD_STREAM[torch.float32])
    assert tiles == 1 and splits == 16 and (splits - 1) * -(-v_tiles // 16) < v_tiles


# (N, V, dtype): Llama-3-8B's and BLOOM-7b1's training rows (micro 4 x
# seq 2048) and padded vocabs, and a few rows of a small vocab
WIDE_CASES = {"llama3-8b-bf16": (8192, 128256, torch.bfloat16),
              "bloom-7b1-bf16": (8192, 250880, torch.bfloat16),
              "llama3-8b-fp32": (8192, 128256, torch.float32),
              "small": (37, 384, torch.float32)}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_chunks_fit_the_scratch_and_cover_the_vocab(case):
    """The wide backward's vocab chunks: whole 128-column tiles, the ds
    scratch of one chunk within WIDE_SCRATCH_BYTES, every vocab column in
    exactly one chunk; two launches a chunk on the wide path, one call's
    launch on the cluster path."""
    N, V, dtype = WIDE_CASES[case]
    ld = tce.wide_chunk(N, V, dtype)
    elem = torch.tensor([], dtype=dtype).element_size()
    assert ld % tce.WIDE_TILE == 0 and ld >= tce.WIDE_TILE
    assert N * ld * elem <= tce.WIDE_SCRATCH_BYTES or ld == tce.WIDE_TILE
    starts = list(range(0, V, ld))
    covered = [c for v0 in starts for c in range(v0, min(v0 + ld, V))]
    assert covered == list(range(V))
    assert tce.launches_per_call(N, 4096, V, dtype) == 2 * len(starts)
    assert tce.launches_per_call(N, 768, V, dtype) == 1
    assert tce.launches_per_call(N, 768, V, dtype, bias=True) == 2 * len(starts)
    if case == "llama3-8b-bf16":
        assert (ld, len(starts)) == (16384, 8)
    if case == "bloom-7b1-bf16":
        assert (ld, len(starts)) == (16384, 16)


def fwd_tiles(N, V, dtype, splits):
    """The (row tile, vocab tile) pairs each forward block walks, in launch
    order (row tiles fastest), as ``launch_fwd`` in ``cross_entropy.cu``
    cuts them: split s takes vocab tiles [s * per_split, (s + 1) *
    per_split), per_split = ceil(vocab tiles / splits)."""
    tiles = -(-N // tce.FWD_ROWS)
    v_tiles = -(-V // tce.FWD_COLS[dtype])
    per_split = -(-v_tiles // splits)
    return [[(rt, vt) for vt in range(s * per_split, min((s + 1) * per_split, v_tiles))]
            for s in range(splits) for rt in range(tiles)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [37, 4096, 8192])
def test_fwd_grid_walks_every_tile_pair_once(N, dtype):
    """The forward's schedule at GPT-2's vocab (V 50304) over a card of 132
    one-block slots (bf16) or 264 (fp32): every (row tile, vocab tile)
    pair in exactly one block, no split empty, row tiles fastest so a
    vocab range's row tiles go out together."""
    tdt = DTYPES[dtype][1]
    V = 50304
    slots = 132 if tdt == torch.bfloat16 else 264
    tiles, splits = tce.fwd_grid(N, V, tdt, slots)
    v_tiles = -(-V // tce.FWD_COLS[tdt])
    blocks = fwd_tiles(N, V, tdt, splits)
    assert tiles == -(-N // tce.FWD_ROWS) and len(blocks) == tiles * splits
    pairs = [pair for walk in blocks for pair in walk]
    assert sorted(pairs) == [(rt, vt) for rt in range(tiles) for vt in range(v_tiles)]
    assert all(blocks) and 1 <= splits <= v_tiles
    assert [walk[0][0] for walk in blocks[:tiles]] == list(range(tiles))
    if tdt == torch.float32:
        assert splits == tce.FWD_SPLITS_FP32 - 1       # 393 tiles: 13 a split fill 31
    else:                                              # one wave that fills most slots
        assert slots // 2 < tiles * splits <= slots


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# ragged rows and a ragged last vocab tile, at GPT-2's n_embd (768: a
# cluster of 4 slices of 192 columns) and at the other widths: 200 (one
# block, a ragged last 16-column step), 1024, 1280 and 1600 (8 slices of
# 128, 160 and 200 columns)
KERNEL_CASES = {"ragged": (37, 768, 384, 300), "vocab-tail": (200, 768, 1000, 1000),
                "e200-ragged": (37, 200, 1000, 990), "e1024-vocab-tail": (300, 1024, 1000, 999),
                "e1280-ragged": (130, 1280, 384, 300), "e1600-vocab-tail": (200, 1600, 1000, 997)}
# Kernel against the plain version with fp32 products on the same inputs
# (in bf16 only the roundings of ds and of the output stay; the
# JAX-faithful plain version rounds the logits, std ~5.5 here, to bf16,
# which moves p by percents).  Forward: |err| / max(1, |plain|), fp32 sums
# in another order.  dx, dhead: max |err| / max |plain| (bf16: both sides
# round the output, so they part by at most one bf16 ulp, 2^-7 of the max),
# and the softmax part alone, |err|_2 / |softmax part|_2 (dx with the
# one-hot term g * head[label] taken out; dhead over the vocab rows no
# label hits).  The same tolerances as chip_smoke.py's phase 6.
KERNEL_TOL = {"float32": (1e-5, 1e-4, 1e-5), "bfloat16": (1e-5, 1e-2, 2e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_kernels_match_plain(cuda_device, case, dtype):
    N, E, V, vocab = KERNEL_CASES[case]
    fwd_tol, grad_tol, softmax_tol = KERNEL_TOL[dtype]
    tdt = DTYPES[dtype][1]
    x, head, labels = (torch.from_numpy(a).to(cuda_device)
                       for a in make_inputs(N, E, V, vocab, seed=3))
    x, head = x.to(tdt), head.to(tdt)
    g = torch.full((1,), 1.0 / N, device=cuda_device)
    nll, lse = tce.ce_forward(x, head, labels, vocab)
    rnll, rlse = tce.ce_forward_reference(x, head, labels, vocab, fp32_products=True)
    args = (x, head, labels, rlse, g, vocab)
    dx = tce.ce_backward_dx(*args)
    rdx = tce.ce_backward_dx_reference(*args, fp32_products=True)
    dh = tce.ce_backward_dhead(*args)
    rdh = tce.ce_backward_dhead_reference(*args, fp32_products=True)
    torch.cuda.synchronize()
    for got, want in ((nll, rnll), (lse, rlse)):
        assert ((got - want).abs() / want.abs().clamp(min=1.0)).max().item() <= fwd_tol
    hit = torch.zeros(V, dtype=torch.bool, device=cuda_device)
    hit[labels.long()] = True
    free = ~hit & (torch.arange(V, device=cuda_device) < vocab)
    softmax_dx = rdx.float() + g * head[labels.long()].float()
    for got, want, softmax, rows in ((dx, rdx, softmax_dx, slice(None)),
                                     (dh, rdh, rdh.float()[free], free)):
        err = (got.float() - want.float()).abs()
        assert err.max().item() <= grad_tol * want.float().abs().max().item()
        assert (err[rows].norm() / softmax.norm()).item() <= softmax_tol


# the wide backward (n_embd past 1664, or a head bias): (N, E, V, vocab,
# bias, chunk columns or None for the default chunk); ragged rows and a
# ragged vocab, in one chunk and in 256-column chunks (dx summed over them)
WIDE_KERNEL_CASES = {"e1672-one-chunk": (300, 1672, 1000, 999, False, None),
                     "e4096-ragged": (333, 4096, 1000, 990, False, None),
                     "e4096-chunks": (333, 4096, 1000, 990, False, 256),
                     "e768-bias": (200, 768, 1000, 997, True, None),
                     "e4096-bias-chunks": (130, 4096, 1000, 1000, True, 256)}


def wide_case(case, dtype, device, monkeypatch):
    N, E, V, vocab, bias, chunk = WIDE_KERNEL_CASES[case]
    tdt = DTYPES[dtype][1]
    if chunk is not None:      # scratch for `chunk` columns: several chunks at this size
        elem = 2 if dtype == "bfloat16" else 4
        monkeypatch.setattr(tce, "WIDE_SCRATCH_BYTES", N * chunk * elem)
    x, head, labels = (torch.from_numpy(a).to(device)
                       for a in make_inputs(N, E, V, vocab, seed=4))
    # the logits' std at most 5 (0.2 sqrt(E) unscaled): peaked rows, as at E 768
    x, head = x.to(tdt), (head * min(1.0, 25.0 / E ** 0.5)).to(tdt)
    b = torch.from_numpy(make_bias(V, seed=4)).to(device, tdt) if bias else None
    return x, head, labels, b, vocab


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(WIDE_KERNEL_CASES))
def test_cuda_wide_backward_matches_plain(cuda_device, monkeypatch, case, dtype):
    """The wide path's dx and dhead (and dbias), and the forward with a
    bias, against the plain versions with fp32 products, to the cluster
    path's tolerances; each call makes the launches launches_per_call
    counts."""
    x, head, labels, b, vocab = wide_case(case, dtype, cuda_device, monkeypatch)
    N, V = x.shape[0], head.shape[0]
    fwd_tol, grad_tol, softmax_tol = KERNEL_TOL[dtype]
    g = torch.full((1,), 1.0 / N, device=cuda_device)
    tce.reset_counts()
    nll, lse = tce.ce_forward(x, head, labels, vocab, b)
    rnll, rlse = tce.ce_forward_reference(x, head, labels, vocab, fp32_products=True, head_b=b)
    args = (x, head, labels, rlse, g, vocab)
    dx = tce.ce_backward_dx(*args, head_b=b)
    rdx = tce.ce_backward_dx_reference(*args, fp32_products=True, head_b=b)
    dh = tce.ce_backward_dhead(*args, head_b=b)
    rdh = tce.ce_backward_dhead_reference(*args, fp32_products=True, head_b=b)
    torch.cuda.synchronize()
    per_call = tce.launches_per_call(N, x.shape[1], V, x.dtype, bias=b is not None)
    assert per_call > 1 and tce.ce_backward_dx.launches == per_call
    assert tce.ce_backward_dhead.launches == per_call
    if b is not None:
        (dh, db), (rdh, rdb) = dh, rdh
        err = (db.float() - rdb.float()).abs().max().item()
        assert err <= grad_tol * rdb.float().abs().max().item(), f"dbias {err:.3e}"
    for got, want in ((nll, rnll), (lse, rlse)):
        assert ((got - want).abs() / want.abs().clamp(min=1.0)).max().item() <= fwd_tol
    hit = torch.zeros(V, dtype=torch.bool, device=cuda_device)
    hit[labels.long()] = True
    free = ~hit & (torch.arange(V, device=cuda_device) < vocab)
    softmax_dx = rdx.float() + g * head[labels.long()].float()
    for got, want, softmax, rows in ((dx, rdx, softmax_dx, slice(None)),
                                     (dh, rdh, rdh.float()[free], free)):
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs()
        assert err.max().item() <= grad_tol * want.float().abs().max().item()
        assert (err[rows].norm() / softmax.norm()).item() <= softmax_tol
    tce.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_wide_backward_is_bitwise_equal_across_calls(cuda_device, monkeypatch, dtype):
    """dx, dhead and dbias twice on the same inputs over several chunks:
    bitwise equal (every sum in a fixed order, no atomics)."""
    x, head, labels, b, vocab = wide_case("e4096-bias-chunks", dtype, cuda_device, monkeypatch)
    g = torch.full((1,), 1.0 / x.shape[0], device=cuda_device)
    _, lse = tce.ce_forward(x, head, labels, vocab, b)
    runs = [(tce.ce_backward_dx(x, head, labels, lse, g, vocab, head_b=b),
             *tce.ce_backward_dhead(x, head, labels, lse, g, vocab, head_b=b))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.isfinite(a.float()).all() and torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernels_do_not_take(cuda_device):
    x, head, labels = (torch.from_numpy(a).to(cuda_device)
                       for a in make_inputs(8, 100, 128, 128))
    with pytest.raises(ValueError, match="n_embd"):
        tce.ce_forward(x, head, labels, 128)
    x, head, labels = (torch.from_numpy(a).to(cuda_device)
                       for a in make_inputs(8, 768, 128, 128))
    with pytest.raises(TypeError):
        tce.ce_forward(x.half(), head.half(), labels, 128)
    with pytest.raises(TypeError):
        tce.ce_forward(x, head, labels.long(), 128)
    with pytest.raises(ValueError):
        tce.ce_forward(x, head, labels, 129)


@pytest.mark.cuda
def test_cuda_loss_takes_the_kernel_for_every_dtype(cuda_device):
    """gpt_loss's cross-entropy sends every CUDA tensor to the kernel: a
    dtype it does not take raises, it never runs the plain path there."""
    x, head, labels = (torch.from_numpy(a).to(cuda_device)
                       for a in make_inputs(8, 768, 128, 128))
    tce.reset_counts()
    with pytest.raises(TypeError, match="ROADMAP"):
        tgpt.chunked_cross_entropy(x.half()[None], head.half(), labels[None], 128)
    tgpt.chunked_cross_entropy(x[None], head, labels[None], 128)
    assert tce.ce_forward.launches == 1 and tce.ce_forward_reference.calls == 0
    tce.reset_counts()


# rows not a multiple of 64 (nor of the 128-row tile) and a vocab not a
# multiple of the bf16 kernel's 256-column tile (nor of fp32's 128), at
# GPT-2's width and at E 200 (a last 64-column slice of 8 columns)
FORWARD_CASES = {"n1000-v2000": (1000, 768, 2000, 1990), "e200-n333-v1100": (333, 200, 1100, 1100)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_cuda_forward_at_ragged_rows_and_vocab(cuda_device, case, dtype):
    N, E, V, vocab = FORWARD_CASES[case]
    tdt = DTYPES[dtype][1]
    x, head, labels = (torch.from_numpy(a).to(cuda_device)
                       for a in make_inputs(N, E, V, vocab, seed=5))
    x, head = x.to(tdt), head.to(tdt)
    labels[:3] = torch.tensor([vocab - 1, 0, V - 1 if vocab < V else 1], dtype=torch.int32)
    nll, lse = tce.ce_forward(x, head, labels, vocab)
    rnll, rlse = tce.ce_forward_reference(x, head, labels, vocab, fp32_products=True)
    torch.cuda.synchronize()
    for got, want in ((nll, rnll), (lse, rlse)):
        assert torch.isfinite(got).all()
        err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
        assert err <= KERNEL_TOL[dtype][0], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_forward_is_bitwise_equal_across_calls(cuda_device, dtype):
    """The forward twice on the same inputs, with a call of more row tiles
    between: bitwise-equal nll and lse.  The splits are merged in split
    order whatever the order of arrival, and each launch leaves the cached
    counters at 0 for the next (no memset)."""
    tdt = DTYPES[dtype][1]

    def forward(N, V):
        x, head, labels = (torch.from_numpy(a).to(cuda_device)
                           for a in make_inputs(N, 768, V, V, seed=6))
        return tce.ce_forward(x.to(tdt), head.to(tdt), labels, V)
    tce.reset_counts()
    first = forward(700, 6000)
    other = forward(1500, 3000)
    second = forward(700, 6000)
    torch.cuda.synchronize()
    assert tce.ce_forward.launches == 3 and tce.ce_forward_reference.calls == 0
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert all(torch.isfinite(t).all() for t in other)
    counters = tce._FWD_COUNTERS[cuda_device]
    assert not counters.any(), "a launch left an arrival counter set"
    tce.reset_counts()
