"""Parity of the port's decode attention (``deepspeed_tpu_torch/ops/cuda/
decode_attention.py``) with the JAX package's.

On the CPU the port's wrappers run their plain versions; these are held
against JAX's jnp references and against JAX's Pallas kernels in interpret
mode, on the same numpy inputs.  Tolerance: 1e-5 absolute in fp32 (both
sides sum in fp32, in different orders).

The CUDA kernels themselves run only on a card: the ``cuda``-marked tests
at the end skip here and run on the GPU machine
(``python -m pytest tests/test_torch_decode_attention.py -m cuda``), and
``chip_smoke.py`` holds them against the plain versions at the serving
shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops.attention import alibi_slopes
from deepspeed_tpu_torch.ops.cuda import decode_attention as tda

ATOL = 1e-5


def make_paged(B=2, Sq=1, H=4, D=16, Hkv=None, NB=24, BS=8, MB=8, seed=0,
               lengths=(20, 15)):
    """Random arena, distinct shuffled physical blocks per row, numpy."""
    Hkv = Hkv or H
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    free = list(range(1, NB))
    rng.shuffle(free)
    tables = np.asarray([[free.pop() for _ in range(MB)] for _ in range(B)],
                        np.int32)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lengths[:B], np.int32)


def both(fn_jax, fn_torch, *arrays):
    """Run the JAX and the port function on the same numpy inputs."""
    j = np.asarray(fn_jax(*[jnp.asarray(a) for a in arrays]))
    t = fn_torch(*[torch.from_numpy(a) for a in arrays]).numpy()
    return j, t


PAGED_CASES = {
    # name: make_paged kwargs
    "mha-decode": dict(Sq=1, lengths=(20, 15)),
    "gqa-decode": dict(Sq=1, H=8, Hkv=2, lengths=(13, 40)),
    "mha-chunk": dict(Sq=4, lengths=(9, 30)),
    "gqa-chunk": dict(Sq=4, H=8, Hkv=4, lengths=(3, 21)),
    "padded-chunk-past-table": dict(Sq=8, lengths=(57, 62)),   # len+Sq > MB*BS
    "length-zero": dict(Sq=1, lengths=(0, 1)),
    "prefill-from-zero": dict(Sq=8, lengths=(0, 0)),
    # edges of the CUDA kernels' tiling (blocks of 16 keys dealt over 8
    # warps for S_q <= 4, 64-query x 64-key tiles above): a table 5 blocks
    # wide (its last key tile crosses the row's end) with len + S_q past it
    # and a ragged query tile; one long row among short and empty ones; GQA
    # rows long enough that every decode warp gets blocks; a 65-row chunk
    "table-width-5-past-end": dict(Sq=17, BS=16, MB=5, lengths=(60, 70)),
    "long-among-short-decode": dict(B=4, Sq=1, BS=16, MB=16, NB=72,
                                    lengths=(0, 3, 250, 1)),
    "gqa-long-multirow-decode": dict(Sq=3, H=8, Hkv=2, BS=16, MB=16, NB=40,
                                     lengths=(200, 129)),
    "ragged-q-tile-65": dict(Sq=65, BS=16, MB=8, lengths=(0, 40)),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_matches_jax_reference(case):
    kw = PAGED_CASES[case]
    arrays = make_paged(seed=sum(map(ord, case)), **kw)
    j, t = both(jda.paged_attention_reference, tda.paged_attention, *arrays)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["mha-decode", "mha-chunk",
                                  "padded-chunk-past-table", "length-zero",
                                  "table-width-5-past-end",
                                  "long-among-short-decode",
                                  "ragged-q-tile-65"])
def test_paged_matches_pallas_interpret(monkeypatch, case):
    """The JAX paged kernel itself (interpret mode on CPU) on the same
    inputs: the port's plain version computes what the TPU kernel does."""
    monkeypatch.setenv("DST_PALLAS_PAGED", "1")
    arrays = make_paged(seed=7, **PAGED_CASES[case])
    j, t = both(jda.paged_attention, tda.paged_attention, *arrays)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_paged_stale_arena_contents_masked():
    """Positions past each row's causal limit (stale block tails, the
    trash block, table slots never written) do not change the output."""
    q, kp, vp, tables, lengths = make_paged(Sq=2, lengths=(11, 5))
    base = tda.paged_attention(*map(torch.from_numpy,
                                    (q, kp, vp, tables, lengths)))
    kp2, vp2 = kp.copy(), vp.copy()
    BS = kp.shape[1]
    for b, n in enumerate(lengths):
        for j in range(tables.shape[1]):
            for o in range(BS):
                if j * BS + o > n + 1:                 # past the last query
                    kp2[tables[b, j], o] = 1e3
                    vp2[tables[b, j], o] = -1e3
    kp2[0] = vp2[0] = 7e3                              # trash block
    out = tda.paged_attention(*map(torch.from_numpy,
                                   (q, kp2, vp2, tables, lengths)))
    np.testing.assert_array_equal(out.numpy(), base.numpy())
    j = np.asarray(jda.paged_attention_reference(
        *map(jnp.asarray, (q, kp2, vp2, tables, lengths))))
    np.testing.assert_allclose(out.numpy(), j, atol=ATOL, rtol=0)


DECODE_CASES = {
    # name: (B, Sq, H, D, T, pos)
    "decode": (2, 1, 4, 16, 64, 37),
    "chunk": (2, 5, 4, 16, 64, 20),
    "prefill-from-zero": (1, 16, 4, 16, 32, 0),
    "ragged-T": (2, 1, 4, 16, 50, 49),
    "ragged-T-chunk": (2, 3, 4, 16, 37, 30),
    # the CUDA kernels' edges, as for PAGED_CASES: a 65-row chunk whose
    # second key tile crosses T; a decode row whose blocks reach every
    # warp; the decode path's most rows; a chunk padded past a ragged T
    "ragged-q-tile-65": (1, 65, 4, 16, 96, 20),
    "long-decode-every-warp": (2, 1, 4, 16, 288, 270),
    "multirow-decode": (2, 4, 4, 16, 160, 140),
    "chunk-past-ragged-T": (1, 17, 4, 16, 70, 60),
}


def make_cache(B, Sq, H, D, T, seed=0, Hkv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    ck = rng.standard_normal((B, T, Hkv or H, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, Hkv or H, D)).astype(np.float32)
    return q, ck, cv


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_jax_reference(case):
    B, Sq, H, D, T, pos = DECODE_CASES[case]
    q, ck, cv = make_cache(B, Sq, H, D, T, seed=3)
    j = np.asarray(jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos)))
    t = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                             torch.from_numpy(cv), pos).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["decode", "chunk", "prefill-from-zero",
                                  "ragged-q-tile-65", "long-decode-every-warp",
                                  "multirow-decode"])
def test_decode_matches_pallas_interpret(monkeypatch, case):
    """JAX's contiguous-cache Pallas kernel (interpret mode) on the same
    inputs; T is a multiple of its block so JAX does not demote it."""
    monkeypatch.setenv("DST_PALLAS_DECODE", "1")
    B, Sq, H, D, T, pos = DECODE_CASES[case]
    q, ck, cv = make_cache(B, Sq, H, D, T, seed=5)
    j = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos),
        block_k=16))
    t = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                             torch.from_numpy(cv), pos).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_paged_equals_contiguous_on_gathered_cache():
    """The paged plain version equals the contiguous one on the gathered
    cache (the serving path and generate() attend to the same thing)."""
    q, kp, vp, tables, lengths = make_paged(Sq=3, lengths=(21, 21))
    B, Sq, H, D = q.shape
    T = tables.shape[1] * kp.shape[1]
    paged = tda.paged_attention(*map(torch.from_numpy,
                                     (q, kp, vp, tables, lengths)))
    ck = torch.from_numpy(kp[tables].reshape(B, T, H, D))
    cv = torch.from_numpy(vp[tables].reshape(B, T, H, D))
    dense = tda.decode_attention(torch.from_numpy(q), ck, cv, 21)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tda.reset_counts()
    arrays = [torch.from_numpy(a) for a in make_paged()]
    tda.paged_attention(*arrays)
    q, ck, cv = map(torch.from_numpy, make_cache(1, 1, 4, 16, 16))
    tda.decode_attention(q, ck, cv, 3)
    assert tda.paged_attention.launches == 0
    assert tda.decode_attention.launches == 0
    assert tda.paged_attention_reference.calls == 1
    assert tda.decode_attention_reference.calls == 1
    tda.reset_counts()


def test_other_devices_raise():
    q = torch.empty(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tda.decode_attention(q, q, q, 0)
    with pytest.raises(ValueError, match="no kernel"):
        tda.paged_attention(q, q, q, q, q)


# head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J), the widths the kernels take
# besides 64 and 128: the plain versions against JAX's Pallas kernels in
# interpret mode (MHA, the kernels' case) and JAX's references (GQA), on
# small tables and caches
SERVING_HEAD_DIMS = (96, 256)
HEAD_DIM_CASES = {
    # name: (paged?, make_paged / make_cache arguments)
    "paged-decode": (True, dict(Sq=1, H=2, BS=8, MB=4, NB=12, lengths=(20, 7))),
    "paged-chunk": (True, dict(Sq=6, H=2, BS=8, MB=4, NB=12, lengths=(3, 25))),
    "paged-gqa-decode": (True, dict(Sq=2, H=4, Hkv=2, BS=8, MB=4, NB=12, lengths=(0, 29))),
    "contiguous-decode": (False, (2, 1, 2, 48, 40)),     # B, Sq, H, T, pos
    "contiguous-chunk": (False, (1, 9, 2, 32, 11)),
}


@pytest.mark.parametrize("D", SERVING_HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(HEAD_DIM_CASES))
def test_head_dims_96_256_match_jax(monkeypatch, case, D):
    paged, args = HEAD_DIM_CASES[case]
    if paged:
        monkeypatch.setenv("DST_PALLAS_PAGED", "1")
        arrays = make_paged(D=D, seed=D, **args)
        fn = jda.paged_attention if "gqa" not in case else jda.paged_attention_reference
        j, t = both(fn, tda.paged_attention, *arrays)
    else:
        monkeypatch.setenv("DST_PALLAS_DECODE", "1")
        B, Sq, H, T, pos = args
        q, ck, cv = make_cache(B, Sq, H, D, T, seed=D)
        j = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                            jnp.int32(pos), block_k=16))
        t = tda.decode_attention(*map(torch.from_numpy, (q, ck, cv)), pos).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# the cases above run on the card at GPT-2's head_dim 64 and blocks of 16
# keys; MB = 4 keeps the CPU cases' 64-slot table rows (len + S_q > MB*BS
# still holds).  The head_dim 128 cases (GQA, ALiBi) follow below.
KERNEL_HEAD_DIM = 64
KERNEL_SHAPE = dict(D=KERNEL_HEAD_DIM, BS=tda.KERNEL_TILE, MB=4)

# generate()'s own shapes for GPT-2 XL (25 heads): a 300-token prompt
# prefilled from position 0 into a 332-slot cache, then a decode step whose
# cache tail is masked
GPT2XL_DECODE_CASES = {
    "gpt2xl-prefill": (1, 300, 25, 64, 332, 0),
    "gpt2xl-decode": (1, 1, 25, 64, 332, 200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_cuda_paged_kernel_matches_plain(cuda_device, case, dtype, tol):
    arrays = make_paged(seed=11, **{**KERNEL_SHAPE, **PAGED_CASES[case]})
    q, kp, vp = (torch.from_numpy(a).to(cuda_device, dtype) for a in arrays[:3])
    tables, lengths = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    out = tda.paged_attention(q, kp, vp, tables, lengths)
    ref = tda.paged_attention_reference(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
    assert diff.max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(DECODE_CASES)
                         + sorted(GPT2XL_DECODE_CASES))
def test_cuda_decode_kernel_matches_plain(cuda_device, case, dtype, tol):
    B, Sq, H, _, T, pos = {**DECODE_CASES, **GPT2XL_DECODE_CASES}[case]
    q, ck, cv = (torch.from_numpy(a).to(cuda_device, dtype)
                 for a in make_cache(B, Sq, H, KERNEL_HEAD_DIM, T, seed=13))
    out = tda.decode_attention(q, ck, cv, pos)
    ref = tda.decode_attention_reference(q, ck, cv, pos)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
    assert diff.max().item() <= tol


@pytest.mark.cuda
def test_cuda_paged_and_contiguous_kernels_agree_bitwise(cuda_device):
    """fp32: the two kernels share one device function, so generate() and
    the serving path attend identically."""
    q, kp, vp, tables, lengths = make_paged(Sq=5, NB=12, lengths=(17, 17),
                                            **KERNEL_SHAPE)
    B, Sq, H, D = q.shape
    T = tables.shape[1] * kp.shape[1]
    dev = cuda_device
    args = [torch.from_numpy(a).to(dev) for a in (q, kp, vp, tables, lengths)]
    paged = tda.paged_attention(*args)
    ck = torch.from_numpy(kp[tables].reshape(B, T, H, D)).to(dev)
    cv = torch.from_numpy(vp[tables].reshape(B, T, H, D)).to(dev)
    dense = tda.decode_attention(args[0], ck, cv, 17)
    assert torch.equal(paged, dense)


# bf16 at peaked scores: q scaled so the score std is ~3 (as chip_smoke.py
# does for flash), where the softmax is far from flat and a lost 16-key
# block moves o by several percent; held against the plain version on the
# same bf16 inputs computed in fp32, by relative L2.  The kernel's own
# error there is bf16 rounding of p and of o, ~2e-3 (2^-9 relative each).
PEAKED_Q_STD = 3.0
PEAKED_L2_TOL = 5e-3


def rel_l2(out, ref):
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_cuda_paged_kernel_bf16_peaked(cuda_device, case):
    arrays = make_paged(seed=19, **{**KERNEL_SHAPE, **PAGED_CASES[case]})
    q, kp, vp = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                 for a in (arrays[0] * PEAKED_Q_STD,) + arrays[1:3])
    tables, lengths = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    out = tda.paged_attention(q, kp, vp, tables, lengths)
    ref = tda.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                        tables, lengths)
    torch.cuda.synchronize()
    assert rel_l2(out, ref) <= PEAKED_L2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DECODE_CASES)
                         + sorted(GPT2XL_DECODE_CASES))
def test_cuda_decode_kernel_bf16_peaked(cuda_device, case):
    B, Sq, H, _, T, pos = {**DECODE_CASES, **GPT2XL_DECODE_CASES}[case]
    q, ck, cv = make_cache(B, Sq, H, KERNEL_HEAD_DIM, T, seed=23)
    q, ck, cv = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                 for a in (q * PEAKED_Q_STD, ck, cv))
    out = tda.decode_attention(q, ck, cv, pos)
    ref = tda.decode_attention_reference(q.float(), ck.float(), cv.float(), pos)
    torch.cuda.synchronize()
    assert rel_l2(out, ref) <= PEAKED_L2_TOL


@pytest.mark.cuda
def test_cuda_prefill_rows_do_not_depend_on_chunking(cuda_device):
    """fp32: a 300-token prompt prefilled whole (generate()'s contiguous
    call) and in chunks of 64 (contiguous, and paged with the last chunk
    padded to 64 as the serving engine sends it) gives bit-identical rows:
    a row's result depends only on its position and the keys."""
    rng = np.random.default_rng(29)
    H, D, BS, P, C = 4, KERNEL_HEAD_DIM, tda.KERNEL_TILE, 300, 64
    T, MB = 332, 21                         # the table holds 336 keys
    q = rng.standard_normal((1, P, H, D)).astype(np.float32)
    k = rng.standard_normal((MB * BS, H, D)).astype(np.float32)
    v = rng.standard_normal((MB * BS, H, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, MB + 1)).astype(np.int32)
    kp = np.zeros((MB + 1, BS, H, D), np.float32)
    vp = np.zeros_like(kp)
    kp[ids], vp[ids] = k.reshape(MB, BS, H, D), v.reshape(MB, BS, H, D)
    dev = cuda_device
    qd = torch.from_numpy(q).to(dev)
    ck, cv = (torch.from_numpy(a[None, :T]).to(dev) for a in (k, v))
    kp, vp = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    table = torch.from_numpy(ids[None]).to(dev)
    whole = tda.decode_attention(qd, ck, cv, 0)
    contiguous, paged = [], []
    for s in range(0, P, C):
        n = min(C, P - s)
        contiguous.append(tda.decode_attention(
            qd[:, s:s + n].contiguous(), ck, cv, s))
        padded = torch.zeros(1, C, H, D, device=dev)
        padded[:, :n] = qd[:, s:s + n]
        paged.append(tda.paged_attention(
            padded, kp, vp, table,
            torch.tensor([s], dtype=torch.int32, device=dev))[:, :n])
    assert torch.equal(torch.cat(contiguous, dim=1), whole)
    assert torch.equal(torch.cat(paged, dim=1), whole)


@pytest.mark.cuda
def test_cuda_decode_rows_do_not_depend_on_s_q(cuda_device):
    """fp32: each row of a decode-path call with S_q = 2..4 equals the
    S_q = 1 call at its own position, in both kernels."""
    B, H, T, pos, R = 2, 4, 300, 250, tda.DECODE_MAX_ROWS
    q, ck, cv = (torch.from_numpy(a).to(cuda_device)
                 for a in make_cache(B, R, H, KERNEL_HEAD_DIM, T, seed=31))
    NB, BS = T // tda.KERNEL_TILE + 2, tda.KERNEL_TILE    # 19 blocks: 304 keys
    kp = torch.zeros(NB, BS, H, KERNEL_HEAD_DIM, device=cuda_device)
    vp = torch.zeros_like(kp)
    kp[1:, :].view(-1, H, KERNEL_HEAD_DIM)[:T] = ck[0]
    vp[1:, :].view(-1, H, KERNEL_HEAD_DIM)[:T] = cv[0]
    table = torch.arange(1, NB, dtype=torch.int32, device=cuda_device)[None]
    for sq in range(2, R + 1):
        out = tda.decode_attention(q[:, :sq].contiguous(), ck, cv, pos)
        pout = tda.paged_attention(
            q[:1, :sq].contiguous(), kp, vp, table,
            torch.tensor([pos], dtype=torch.int32, device=cuda_device))
        for i in range(sq):
            one = tda.decode_attention(q[:, i:i + 1].contiguous(), ck, cv,
                                       pos + i)
            assert torch.equal(out[:, i:i + 1], one)
            assert torch.equal(pout[:, i:i + 1], one[:1])


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernel_does_not_take(cuda_device):
    arrays = make_paged(**KERNEL_SHAPE)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in arrays)
    other_bs = [torch.from_numpy(a).to(cuda_device) for a in make_paged(
        D=KERNEL_HEAD_DIM, BS=8, MB=8)]
    with pytest.raises(ValueError, match="block_size"):
        tda.paged_attention(*other_bs)
    other_d = [torch.from_numpy(a).to(cuda_device) for a in make_paged(
        D=32, BS=tda.KERNEL_TILE, MB=4)]
    with pytest.raises(ValueError, match="head_dim"):
        tda.paged_attention(*other_d)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention(*[torch.from_numpy(a).to(cuda_device)
                               for a in make_cache(1, 1, 4, 32, 16)], 3)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_attention(*[torch.from_numpy(a).to(cuda_device)
                               for a in make_cache(1, 1, 4, 80, 16)], 3)
    with pytest.raises(NotImplementedError):
        tda.paged_attention(q, kp, vp, tables, lengths, bias=torch.zeros(1))
    with pytest.raises(ValueError, match="alibi"):
        tda.paged_attention(q, kp, vp, tables, lengths,
                            alibi=torch.ones(q.shape[2] + 1, device=cuda_device))
    with pytest.raises(ValueError, match="alibi"):
        tda.paged_attention(q, kp, vp, tables, lengths,
                            alibi=torch.ones(q.shape[2], dtype=torch.float64,
                                             device=cuda_device))
    with pytest.raises(TypeError):
        tda.paged_attention(q.half(), kp.half(), vp.half(), tables, lengths)
    with pytest.raises(TypeError):
        tda.paged_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError):
        tda.paged_attention(q.transpose(1, 2), kp, vp, tables, lengths)


# --------------------------------------------------------------------------- #
# on the card at head_dim 128: the LLaMA and BLOOM serving shapes
# --------------------------------------------------------------------------- #
# name: (H, Hkv, alibi, S_q, lengths of the paged rows, T, pos of the
# contiguous call).  Llama-3-8B's heads (32 over 8 kv heads: G 4), G 1 and
# 8, BLOOM's ALiBi (H 32, G 1) and ALiBi with GQA; decode rows of ragged
# lengths (0, inside a block, past every warp's first block), the decode
# path's most rows, and prefill chunks whose last key tile crosses the
# table's end or a ragged T
WIDE_CASES = {
    "llama3-g4-decode": (32, 8, False, 1, (0, 17, 300, 1023), 1000, 999),
    "g1-decode": (8, 8, False, 1, (15, 16, 129, 700), 333, 200),
    "g8-multirow-decode": (16, 2, False, 4, (0, 250, 1019, 31), 1024, 1020),
    "bloom-alibi-decode": (32, 32, True, 1, (1, 64, 511, 1022), 1023, 1022),
    "g4-alibi-decode": (8, 2, True, 2, (3, 140, 900, 0), 700, 650),
    "g4-prefill-65": (8, 2, False, 65, (0, 40, 959, 7), 300, 0),
    "bloom-alibi-prefill": (8, 8, True, 70, (0, 100, 954, 33), 400, 120),
    "g8-alibi-chunk": (16, 2, True, 17, (60, 1007, 5, 333), 70, 53),
}
WIDE_D, WIDE_MB = 128, 64          # 1024 keys a table row


def wide_paged(case, dtype, device, seed, D=WIDE_D):
    H, Hkv, alibi, Sq, lengths, _, _ = WIDE_CASES[case]
    arrays = make_paged(B=len(lengths), Sq=Sq, H=H, Hkv=Hkv, D=D, BS=tda.KERNEL_TILE,
                        MB=WIDE_MB, NB=len(lengths) * WIDE_MB + 1, seed=seed,
                        lengths=lengths)
    q, kp, vp = (torch.from_numpy(a).to(device, dtype) for a in arrays[:3])
    tables, lens = (torch.from_numpy(a).to(device) for a in arrays[3:])
    return q, kp, vp, tables, lens, slopes_of(case, device)


def wide_cache(case, dtype, device, seed, B=2, D=WIDE_D):
    H, Hkv, _, Sq, _, T, pos = WIDE_CASES[case]
    q, ck, cv = (torch.from_numpy(a).to(device, dtype)
                 for a in make_cache(B, Sq, H, D, T, seed=seed, Hkv=Hkv))
    return q, ck, cv, pos, slopes_of(case, device)


def slopes_of(case, device):
    H, _, alibi = WIDE_CASES[case][:3]
    return torch.from_numpy(alibi_slopes(H)).to(device) if alibi else None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_cuda_head_dim_128_paged_matches_plain(cuda_device, case, dtype, tol):
    tda.reset_counts()
    q, kp, vp, tables, lens, slopes = wide_paged(case, dtype, cuda_device, seed=41)
    out = tda.paged_attention(q, kp, vp, tables, lens, alibi=slopes)
    assert tda.paged_attention.launches == 1
    ref = tda.paged_attention_reference(q, kp, vp, tables, lens, alibi=slopes)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
    assert diff.max().item() <= tol
    if dtype == torch.bfloat16:
        qq = q * PEAKED_Q_STD
        out = tda.paged_attention(qq, kp, vp, tables, lens, alibi=slopes)
        ref = tda.paged_attention_reference(qq.float(), kp.float(), vp.float(), tables,
                                            lens, alibi=slopes)
        assert rel_l2(out, ref) <= PEAKED_L2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_cuda_head_dim_128_contiguous_matches_plain(cuda_device, case, dtype, tol):
    tda.reset_counts()
    q, ck, cv, pos, slopes = wide_cache(case, dtype, cuda_device, seed=43)
    out = tda.decode_attention(q, ck, cv, pos, alibi=slopes)
    assert tda.decode_attention.launches == 1
    ref = tda.decode_attention_reference(q, ck, cv, pos, alibi=slopes)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
    assert diff.max().item() <= tol
    if dtype == torch.bfloat16:
        qq = q * PEAKED_Q_STD
        out = tda.decode_attention(qq, ck, cv, pos, alibi=slopes)
        ref = tda.decode_attention_reference(qq.float(), ck.float(), cv.float(), pos,
                                             alibi=slopes)
        assert rel_l2(out, ref) <= PEAKED_L2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["llama3-g4-decode", "g4-alibi-decode",
                                  "bloom-alibi-prefill", "g8-alibi-chunk"])
def test_cuda_head_dim_128_paged_and_contiguous_agree_bitwise(cuda_device, case):
    """fp32: on the cache gathered through the tables, the two kernels give
    the same bits with GQA and ALiBi, as at head_dim 64."""
    q, kp, vp, tables, lens, slopes = wide_paged(case, torch.float32, cuda_device, seed=47)
    B, Sq, H, D = q.shape
    pos = 500
    lens = torch.full_like(lens, pos)
    T = tables.shape[1] * kp.shape[1]
    paged = tda.paged_attention(q, kp, vp, tables, lens, alibi=slopes)
    ck, cv = (p[tables.long()].reshape(B, T, -1, D) for p in (kp, vp))
    dense = tda.decode_attention(q, ck, cv, pos, alibi=slopes)
    assert torch.equal(paged, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
def test_cuda_head_dim_128_prefill_rows_do_not_depend_on_chunking(cuda_device, alibi):
    """fp32, Llama-3-8B's heads (and BLOOM's ALiBi): a 300-token prompt
    prefilled whole and in chunks of 64 (contiguous, and paged with the last
    chunk padded) gives bit-identical rows, and each decode-path row equals
    the S_q = 1 call at its own position."""
    rng = np.random.default_rng(53)
    H, Hkv, D, BS, P, C = 32, 8, WIDE_D, tda.KERNEL_TILE, 300, 64
    T, MB = 332, 21
    dev = cuda_device
    slopes = torch.from_numpy(alibi_slopes(H)).to(dev) if alibi else None
    q = torch.from_numpy(rng.standard_normal((1, P, H, D)).astype(np.float32)).to(dev)
    k = rng.standard_normal((MB * BS, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((MB * BS, Hkv, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, MB + 1)).astype(np.int32)
    kp = np.zeros((MB + 1, BS, Hkv, D), np.float32)
    vp = np.zeros_like(kp)
    kp[ids], vp[ids] = k.reshape(MB, BS, Hkv, D), v.reshape(MB, BS, Hkv, D)
    ck, cv = (torch.from_numpy(a[None, :T]).to(dev) for a in (k, v))
    kp, vp = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    table = torch.from_numpy(ids[None]).to(dev)
    whole = tda.decode_attention(q, ck, cv, 0, alibi=slopes)
    contiguous, paged = [], []
    for s in range(0, P, C):
        n = min(C, P - s)
        contiguous.append(tda.decode_attention(q[:, s:s + n].contiguous(), ck, cv, s,
                                               alibi=slopes))
        padded = torch.zeros(1, C, H, D, device=dev)
        padded[:, :n] = q[:, s:s + n]
        paged.append(tda.paged_attention(
            padded, kp, vp, table, torch.tensor([s], dtype=torch.int32, device=dev),
            alibi=slopes)[:, :n])
    assert torch.equal(torch.cat(contiguous, dim=1), whole)
    assert torch.equal(torch.cat(paged, dim=1), whole)
    pos = 250
    rows = tda.decode_attention(q[:, :tda.DECODE_MAX_ROWS].contiguous(), ck, cv, pos,
                                alibi=slopes)
    for i in range(tda.DECODE_MAX_ROWS):
        one = tda.decode_attention(q[:, i:i + 1].contiguous(), ck, cv, pos + i, alibi=slopes)
        assert torch.equal(rows[:, i:i + 1], one)


# --------------------------------------------------------------------------- #
# on the card at head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J): the lane
# layouts that are not a power of two (96: 12 or 24 chunks a key row over
# 16 or 32 lanes) or wider than a warp (fp32 at 256: two chunks a lane, a
# block in two parts), and the prefill path's single K/V buffer (fp32 at
# 256), over the head_dim-128 cases (GQA, ALiBi, ragged rows and chunks)
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("D", SERVING_HEAD_DIMS)
def test_cuda_head_dims_96_256_match_plain(cuda_device, D, case, dtype, tol):
    tda.reset_counts()
    q, kp, vp, tables, lens, slopes = wide_paged(case, dtype, cuda_device, seed=59, D=D)
    paged = tda.paged_attention(q, kp, vp, tables, lens, alibi=slopes)
    rpaged = tda.paged_attention_reference(q, kp, vp, tables, lens, alibi=slopes)
    q2, ck, cv, pos, _ = wide_cache(case, dtype, cuda_device, seed=61, D=D)
    dense = tda.decode_attention(q2, ck, cv, pos, alibi=slopes)
    rdense = tda.decode_attention_reference(q2, ck, cv, pos, alibi=slopes)
    assert (tda.paged_attention.launches, tda.decode_attention.launches) == (1, 1)
    torch.cuda.synchronize()
    for out, ref in ((paged, rpaged), (dense, rdense)):
        assert torch.isfinite(out.float()).all()
        diff = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)
        assert diff.max().item() <= tol
    if dtype == torch.bfloat16:
        out = tda.paged_attention(q * PEAKED_Q_STD, kp, vp, tables, lens, alibi=slopes)
        ref = tda.paged_attention_reference(q.float() * PEAKED_Q_STD, kp.float(), vp.float(),
                                            tables, lens, alibi=slopes)
        assert rel_l2(out, ref) <= PEAKED_L2_TOL
        out = tda.decode_attention(q2 * PEAKED_Q_STD, ck, cv, pos, alibi=slopes)
        ref = tda.decode_attention_reference(q2.float() * PEAKED_Q_STD, ck.float(),
                                             cv.float(), pos, alibi=slopes)
        assert rel_l2(out, ref) <= PEAKED_L2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["llama3-g4-decode", "g4-alibi-decode",
                                  "bloom-alibi-prefill", "g8-alibi-chunk"])
@pytest.mark.parametrize("D", SERVING_HEAD_DIMS)
def test_cuda_head_dims_96_256_paged_and_contiguous_agree_bitwise(cuda_device, D, case):
    q, kp, vp, tables, lens, slopes = wide_paged(case, torch.float32, cuda_device, seed=67,
                                                 D=D)
    B = q.shape[0]
    pos = 500
    lens = torch.full_like(lens, pos)
    T = tables.shape[1] * kp.shape[1]
    paged = tda.paged_attention(q, kp, vp, tables, lens, alibi=slopes)
    ck, cv = (p[tables.long()].reshape(B, T, -1, D) for p in (kp, vp))
    dense = tda.decode_attention(q, ck, cv, pos, alibi=slopes)
    assert torch.equal(paged, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("D", SERVING_HEAD_DIMS)
def test_cuda_head_dims_96_256_rows_do_not_depend_on_chunking(cuda_device, D):
    """fp32, GQA 4:1 with ALiBi: a 200-token prompt prefilled whole and in
    chunks of 64 (contiguous, and paged with the last chunk padded) gives
    bit-identical rows, and each decode-path row equals the S_q = 1 call at
    its own position."""
    rng = np.random.default_rng(71)
    H, Hkv, BS, P, C = 8, 2, tda.KERNEL_TILE, 200, 64
    T, MB = 230, 15
    dev = cuda_device
    slopes = torch.from_numpy(alibi_slopes(H)).to(dev)
    q = torch.from_numpy(rng.standard_normal((1, P, H, D)).astype(np.float32)).to(dev)
    k = rng.standard_normal((MB * BS, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((MB * BS, Hkv, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, MB + 1)).astype(np.int32)
    kp = np.zeros((MB + 1, BS, Hkv, D), np.float32)
    vp = np.zeros_like(kp)
    kp[ids], vp[ids] = k.reshape(MB, BS, Hkv, D), v.reshape(MB, BS, Hkv, D)
    ck, cv = (torch.from_numpy(a[None, :T]).to(dev) for a in (k, v))
    kp, vp = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    table = torch.from_numpy(ids[None]).to(dev)
    whole = tda.decode_attention(q, ck, cv, 0, alibi=slopes)
    contiguous, paged = [], []
    for s in range(0, P, C):
        n = min(C, P - s)
        contiguous.append(tda.decode_attention(q[:, s:s + n].contiguous(), ck, cv, s,
                                               alibi=slopes))
        padded = torch.zeros(1, C, H, D, device=dev)
        padded[:, :n] = q[:, s:s + n]
        paged.append(tda.paged_attention(
            padded, kp, vp, table, torch.tensor([s], dtype=torch.int32, device=dev),
            alibi=slopes)[:, :n])
    assert torch.equal(torch.cat(contiguous, dim=1), whole)
    assert torch.equal(torch.cat(paged, dim=1), whole)
    pos = 150
    rows = tda.decode_attention(q[:, :tda.DECODE_MAX_ROWS].contiguous(), ck, cv, pos,
                                alibi=slopes)
    for i in range(tda.DECODE_MAX_ROWS):
        one = tda.decode_attention(q[:, i:i + 1].contiguous(), ck, cv, pos + i, alibi=slopes)
        assert torch.equal(rows[:, i:i + 1], one)
