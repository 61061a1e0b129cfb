"""Fused cross-entropy over the lm head: hand-written CUDA kernels and
their plain PyTorch versions (counterpart of
``deepspeed_tpu/ops/pallas/cross_entropy.py``).

Layouts are the JAX package's: ``x`` ``[N, E]`` hidden rows, ``head``
``[V, E]`` (the tied ``wte`` or an untied ``lm_head``, vocab padded to a
multiple of 128), ``labels`` ``[N]`` int32, the optional head bias
``head_b`` ``[V]`` (added to the fp32 logits, as JAX's ``_score_block``
adds it); vocab columns at or past ``vocab_size`` are masked with the same
``-1e9`` sentinel as the JAX kernels and reference.  The loss is the mean
nll over the N rows.

Three entry points, one per TPU kernel, each with its plain version:

* ``ce_forward`` -> (nll, lse) per row; replaces ``_fwd_kernel``
  (``ops/pallas/cross_entropy.py:92``);
* ``ce_backward_dx`` -> dx in x's dtype; replaces ``_bwd_dx_kernel``
  (``:182``);
* ``ce_backward_dhead`` -> dhead in head's dtype (and with a head bias
  dbias = the sum over rows of the fp32 ds, in the bias's dtype); replaces
  ``_bwd_dh_kernel`` (``:205``).

Dispatch: a CPU tensor goes to the plain version (``*_reference``, JAX's
``n_chunks == 1`` branch of ``models/gpt.py:chunked_cross_entropy`` and
its hand-derived backward); a CUDA tensor launches the kernel of
``csrc/cross_entropy.cu`` or raises on a dtype, shape or layout the kernel
does not take.  There is no fallback from one to the other.
``cross_entropy`` is the ``torch.autograd.Function`` over the three,
differentiable in x, head and head_b.

Kernel notes (details in the ``.cu`` file): all three are bound by
operations (the score product x . head^T, recomputed in each kernel so no
``[N, V]`` tensor reaches device memory); bf16 inputs go through the
tensor cores, fp32 inputs through fp32 FMA.  The kernels take any n_embd
that is a multiple of 8.  The bf16 forward runs warpgroup MMA on TMA-fed
tiles of 128 rows x ``FWD_COLS`` vocab columns, the online softmax on its
accumulators, over ``fwd_grid``'s vocab splits; the last block of a row
tile merges the splits in split order and resets its arrival counter, so
the counters (``_fwd_counters``, one set per device) are never memset.
dx and dhead take one of two paths (``wide_path``):

* up to ``CLUSTER_MAX_EMBD`` (1664: every GPT-2 width) without a head
  bias, one CUDA kernel run by thread-block clusters of up to
  ``BWD_MAX_CLUSTER`` blocks, each owning a slice of n_embd of at most
  ``BWD_SLICE`` columns: one launch per call;
* past it (LLaMA's and BLOOM's 4096) or with a head bias, the wide path:
  the vocab in chunks of ``wide_chunk`` columns (ds in the input dtype
  for a chunk fits ``WIDE_SCRATCH_BYTES``), each a ds pass (the scores
  again, ds formed and rounded as the plain version rounds it) and a
  hand-written product, dx summed over the chunks in an fp32 buffer in
  chunk order: two launches per chunk (``launches_per_call``), each
  counted.

Each wrapper counts its launches (``ce_forward.launches``); each plain
version counts its calls (``ce_forward_reference.calls``).
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.cuda import builder, capture

PAD_LOGIT = -1e9
# the forward: rows and vocab columns of a tile (by dtype); fp32 keeps a
# fixed 32 vocab splits, bf16 takes fwd_grid's from the card's block slots
FWD_ROWS = 128
FWD_COLS = {torch.bfloat16: 256, torch.float32: 128}
FWD_SPLITS_FP32 = 32
# fwd_grid's estimate of a block's fixed cost (filling the ring, writing and
# merging its partials), in vocab tiles
FWD_BLOCK_COST = 0.5
# the backward: resident rows per cluster and streamed rows per tile (by
# dtype), and the widest slice of n_embd one block of a cluster (at most 8
# blocks) owns
BWD_ROWS = {torch.bfloat16: 128, torch.float32: 64}
BWD_STREAM = {torch.bfloat16: 64, torch.float32: 32}
BWD_SLICE, BWD_MAX_CLUSTER = 208, 8
EMBD_ALIGN = 8           # n_embd a multiple of 8: rows start on 16-byte boundaries
# the widest n_embd the cluster backward takes; wider ones take the wide path
CLUSTER_MAX_EMBD = BWD_SLICE * BWD_MAX_CLUSTER
# the wide backward's ds scratch of one vocab chunk, at most (the chunk a
# multiple of WIDE_TILE columns, at least one tile)
WIDE_SCRATCH_BYTES = 256 * 2 ** 20
WIDE_TILE = 128
OTHER_FAMILIES = "ROADMAP.md, Queue 1: other GPT families"
FP16 = "ROADMAP.md, Queue 1 item 5 (fp16 training)"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def _exact_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from the operands' values summed in fp64, rounded to fp32:
    exact products (as the tensor cores form bf16 ones) and sums whose
    rounding stays far below fp32's.  An fp32 GEMM over n_embd 4096 or a
    128256-column vocab is itself ~2e-5 off in the softmax part (measured
    on the H100 against fp64, ``chip_smoke.py`` phase 6), more than the
    kernels are."""
    return (a.double() @ b.double()).float()


def _exact(x: torch.Tensor, fp32_products: bool) -> bool:
    """Whether the plain products are exact: asked for, or fp32 inputs."""
    return fp32_products or x.dtype == torch.float32


def ce_logits(x: torch.Tensor, head: torch.Tensor, vocab_size: int,
              fp32_products: bool = False,
              head_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[N, V]`` fp32 logits as JAX's unchunked branch forms them:
    ``x @ head^T`` in x's dtype, then fp32, plus the head bias in fp32,
    pad columns ``-1e9``.  fp32 inputs, or any with ``fp32_products``, take
    ``_exact_product`` (for bf16 the product of the kernels, whose bf16 x
    bf16 products are exact in fp32)."""
    if _exact(x, fp32_products):
        logits = _exact_product(x, head.T)
    else:
        logits = (x @ head.to(x.dtype).T).float()
    if head_b is not None:
        logits = logits + head_b.float()
    V = head.shape[0]
    if V != vocab_size:
        keep = torch.arange(V, device=x.device) < vocab_size
        logits = torch.where(keep, logits, PAD_LOGIT)
    return logits


def label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit per row; 0 for a label outside ``[0, V)``, as the
    one-hot contraction gives."""
    V = logits.shape[1]
    lab = labels.long()
    valid = (lab >= 0) & (lab < V)
    ll = logits.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    return torch.where(valid, ll, 0.0)


def ce_forward_reference(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                         vocab_size: int, fp32_products: bool = False,
                         head_b: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (nll, lse), fp32."""
    ce_forward_reference.calls += 1
    logits = ce_logits(x, head, vocab_size, fp32_products, head_b)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - label_logit(logits, labels), lse


ce_forward_reference.calls = 0


def _dlogits(x, head, labels, lse, gscale, vocab_size, fp32_products,
             head_b=None) -> torch.Tensor:
    """(softmax - onehot) * g / N, fp32 ``[N, V]``."""
    logits = ce_logits(x, head, vocab_size, fp32_products, head_b)
    ds = torch.exp(logits - lse[:, None])
    lab = labels.long()
    valid = (lab >= 0) & (lab < ds.shape[1])
    rows = torch.arange(ds.shape[0], device=ds.device)[valid]
    ds[rows, lab[valid]] -= 1.0
    return ds * gscale


def ce_backward_dx_reference(x, head, labels, lse, gscale, vocab_size,
                             fp32_products: bool = False, head_b=None) -> torch.Tensor:
    """dx = ds . head, in x's dtype (ds rounded to x's dtype first, as the
    autograd of the unchunked branch rounds it).  ``fp32_products`` (and
    fp32 inputs): both products exact (``_exact_product``), only the
    roundings of ds and of dx left in x's dtype (what the kernels compute,
    up to summation order)."""
    ce_backward_dx_reference.calls += 1
    ds = _dlogits(x, head, labels, lse, gscale, vocab_size, fp32_products,
                  head_b).to(x.dtype)
    if _exact(x, fp32_products):
        return _exact_product(ds, head).to(x.dtype)
    return (ds @ head.to(x.dtype)).to(x.dtype)


ce_backward_dx_reference.calls = 0


def ce_backward_dhead_reference(x, head, labels, lse, gscale, vocab_size,
                                fp32_products: bool = False, head_b=None):
    """dhead = ds^T . x, in head's dtype (``fp32_products`` as for dx).
    With ``head_b``: (dhead, dbias), dbias the sum over rows of the fp32 ds
    (JAX's ``db_ref += sum(ds)``), in head_b's dtype."""
    ce_backward_dhead_reference.calls += 1
    ds32 = _dlogits(x, head, labels, lse, gscale, vocab_size, fp32_products, head_b)
    ds = ds32.to(x.dtype)
    if _exact(x, fp32_products):
        dh = _exact_product(ds.T, x).to(head.dtype)
    else:
        dh = (ds.T @ x).to(head.dtype)
    if head_b is None:
        return dh
    return dh, ds32.sum(0).to(head_b.dtype)


ce_backward_dhead_reference.calls = 0


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def check_embd(name: str, E: int) -> None:
    """The widths the kernels take: a positive multiple of 8."""
    if E <= 0 or E % EMBD_ALIGN:
        raise ValueError(f"{name}: the CUDA kernels take n_embd a positive multiple of "
                         f"{EMBD_ALIGN}, got {E} ({OTHER_FAMILIES})")


def wide_path(E: int, bias: bool = False) -> bool:
    """Whether dx and dhead take the wide path (n_embd past the cluster
    kernel's ``CLUSTER_MAX_EMBD``, or a head bias) rather than the cluster
    kernel."""
    return E > CLUSTER_MAX_EMBD or bias


def wide_chunk(N: int, V: int, dtype: torch.dtype) -> int:
    """Vocab columns per chunk of the wide backward: the most whose ds
    (``N`` rows in ``dtype``) fits ``WIDE_SCRATCH_BYTES``, a multiple of
    ``WIDE_TILE``, at least one tile and no more than V rounded up."""
    per_column = N * torch.tensor([], dtype=dtype).element_size()
    fit = max(WIDE_TILE, WIDE_SCRATCH_BYTES // per_column // WIDE_TILE * WIDE_TILE)
    return min(fit, -(-V // WIDE_TILE) * WIDE_TILE)


def launches_per_call(N: int, E: int, V: int, dtype: torch.dtype, bias: bool = False) -> int:
    """Kernel launches one ``ce_backward_dx`` or ``ce_backward_dhead`` call
    makes: 1 on the cluster path, a ds pass and a product per vocab chunk
    on the wide path."""
    if not wide_path(E, bias):
        return 1
    return 2 * -(-V // wide_chunk(N, V, dtype))


def _check_bias(name: str, head_b: Optional[torch.Tensor], V: int,
                device: torch.device) -> Optional[torch.Tensor]:
    """The head bias as the kernels take it (contiguous fp32 [V] on the
    device), or None."""
    if head_b is None:
        return None
    if head_b.dim() != 1 or head_b.shape[0] != V or head_b.device != device:
        raise ValueError(f"{name}: head_b must be [{V}] on {device}, got "
                         f"{tuple(head_b.shape)} on {head_b.device}")
    return head_b.detach().float().contiguous()


def _check_cuda(name: str, x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                vocab_size: int, *row_vectors: torch.Tensor) -> int:
    """Validate what the kernels take; returns the dtype code."""
    if x.dtype not in _DTYPE_CODES or head.dtype != x.dtype:
        raise TypeError(f"{name}: CUDA kernel takes float32 or bfloat16 x and head of one "
                        f"dtype, got {x.dtype} and {head.dtype}"
                        + (f" (float16 is not ported yet: {FP16})"
                           if torch.float16 in (x.dtype, head.dtype) else ""))
    if x.dim() != 2 or head.dim() != 2 or head.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: x must be [N, E] and head [V, E], got "
                         f"{tuple(x.shape)} and {tuple(head.shape)}")
    N, E = x.shape
    V = head.shape[0]
    check_embd(name, E)
    if not 0 < vocab_size <= V:
        raise ValueError(f"{name}: vocab_size {vocab_size} not in (0, {V}]")
    if N == 0 or N >= 2 ** 31 or V >= 2 ** 31:
        raise ValueError(f"{name}: N {N}, V {V} out of range")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (N,):
        raise TypeError(f"{name}: labels must be int32 [{N}], got {labels.dtype} "
                        f"{tuple(labels.shape)}")
    for t in (x, head, labels) + row_vectors:
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, got one on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA kernel takes contiguous tensors")
    for t in (x, head):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: x and head must start on a 16-byte boundary")
    for t in row_vectors:
        if t.dtype != torch.float32 or t.numel() not in (1, N):
            raise TypeError(f"{name}: lse must be fp32 [{N}] and gscale fp32 [1]")
    return _DTYPE_CODES[x.dtype]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _active_clusters(E: int, dtype_code: int, device_index: int) -> int:
    """Clusters of the backward kernel the card holds at once (the CUDA
    occupancy query; a block fills an SM, and a cluster's blocks share a GPC)."""
    lib = builder.load_library()
    with torch.cuda.device(device_index):
        n = lib.dst_ce_backward_active_clusters(E, dtype_code)
    if n <= 0:
        raise RuntimeError(f"cross-entropy backward: the device holds no cluster at n_embd {E}")
    return n


def dx_grid(N: int, V: int, dtype: torch.dtype, active: int) -> Tuple[int, int]:
    """(row tiles, vocab splits) of the dx kernel: a cluster per row tile,
    times the vocab splits that finish soonest when the card holds
    ``active`` clusters at once (waves x tiles per split; the fewest splits
    among equals, every split at least one tile)."""
    tiles = -(-N // BWD_ROWS[dtype])
    v_tiles = -(-V // BWD_STREAM[dtype])
    best = None
    for want in range(1, min(16, v_tiles) + 1):
        per_split = -(-v_tiles // want)
        splits = -(-v_tiles // per_split)
        cost = -(-tiles * splits // active) * per_split
        if best is None or cost < best[0]:
            best = (cost, splits)
    return tiles, best[1]


def fwd_grid(N: int, V: int, dtype: torch.dtype, slots: int) -> Tuple[int, int]:
    """(row tiles, vocab splits) of the forward: bf16 the split count whose
    waves of ``slots`` blocks (the card's SMs x blocks per SM) finish
    soonest, each block costing its tiles plus ``FWD_BLOCK_COST`` (the
    fewest splits among equals); fp32 ``FWD_SPLITS_FP32``.  Either way no
    more splits than vocab tiles, and every split non-empty."""
    tiles = -(-N // FWD_ROWS)
    v_tiles = -(-V // FWD_COLS[dtype])
    if dtype != torch.bfloat16:
        return tiles, -(-v_tiles // -(-v_tiles // min(FWD_SPLITS_FP32, v_tiles)))
    best = None
    for want in range(1, v_tiles + 1):
        per_split = -(-v_tiles // want)
        splits = -(-v_tiles // per_split)
        cost = -(-tiles * splits // slots) * (per_split + FWD_BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return tiles, best[1]


def kernel_occupancy(dtype: torch.dtype) -> Tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of the
    forward kernel for ``dtype`` on the current card, by CUDA's occupancy
    query.  Launches nothing."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel_occupancy: no forward kernel for {dtype}")
    lib = builder.load_library()
    smem = ctypes.c_int(0)
    blocks = lib.dst_ce_forward_occupancy(_DTYPE_CODES[dtype], ctypes.byref(smem))
    if blocks <= 0:
        raise RuntimeError("kernel_occupancy: the occupancy query failed")
    return blocks, smem.value


@functools.lru_cache(maxsize=None)
def _fwd_slots(dtype: torch.dtype, device_index: int) -> int:
    """Forward blocks the card holds at once: SMs x blocks per SM."""
    with torch.cuda.device(device_index):
        blocks, _ = kernel_occupancy(dtype)
    return torch.cuda.get_device_properties(device_index).multi_processor_count * blocks


_FWD_COUNTERS = {}


def _fwd_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """The forward's arrival counters (one per row tile) on ``device``: made
    zero once and kept, since each launch leaves them at 0; grown when a
    call has more row tiles.  Calls that share them must run on one
    stream."""
    counters = _FWD_COUNTERS.get(device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
        _FWD_COUNTERS[device] = counters
    return capture.hold(counters)


def ce_forward(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               vocab_size: int, head_b: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (nll, lse) in fp32 without materializing logits.  CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return ce_forward_reference(x, head, labels, vocab_size, head_b=head_b)
    if x.device.type != "cuda":
        raise ValueError(f"ce_forward: no kernel for device {x.device}")
    dtype = _check_cuda("ce_forward", x, head, labels, vocab_size)
    N, E = x.shape
    V = head.shape[0]
    bias = _check_bias("ce_forward", head_b, V, x.device)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    tiles, splits = fwd_grid(N, V, x.dtype, _fwd_slots(x.dtype, index))
    f32 = dict(dtype=torch.float32, device=x.device)
    nll, lse = torch.empty(N, **f32), torch.empty(N, **f32)
    part = torch.empty(splits * 3 * N, **f32)
    counters = _fwd_counters(torch.device("cuda", index), tiles)
    lib = builder.load_library()
    rc = lib.dst_ce_forward(x.data_ptr(), head.data_ptr(), labels.data_ptr(),
                            None if bias is None else bias.data_ptr(),
                            part.data_ptr(), counters.data_ptr(), nll.data_ptr(),
                            lse.data_ptr(), N, E, V, vocab_size, splits, dtype, _stream(x))
    builder.check(lib, rc, "ce_forward")
    ce_forward.launches += 1
    return nll, lse


ce_forward.launches = 0


def _wide_chunks(x: torch.Tensor, head: torch.Tensor):
    """(chunk width, [(v0, first, last)], ds scratch) of the wide path."""
    N, V = x.shape[0], head.shape[0]
    ld = wide_chunk(N, V, x.dtype)
    starts = list(range(0, V, ld))
    chunks = [(v0, i == 0, i == len(starts) - 1) for i, v0 in enumerate(starts)]
    return ld, chunks, torch.empty((N, ld), dtype=x.dtype, device=x.device)


def _wide_ds(lib, x, head, labels, lse, gscale, bias, ds, colsum, vocab_size, v0, ld,
             for_dhead: bool, dtype: int) -> None:
    N, E = x.shape
    rc = lib.dst_ce_wide_ds(x.data_ptr(), head.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                            gscale.data_ptr(), None if bias is None else bias.data_ptr(),
                            ds.data_ptr(), None if colsum is None else colsum.data_ptr(),
                            N, E, head.shape[0], vocab_size, v0, ld, int(for_dhead), dtype,
                            _stream(x))
    builder.check(lib, rc, "cross-entropy backward (ds pass)")


def ce_backward_dx(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                   lse: torch.Tensor, gscale: torch.Tensor, vocab_size: int,
                   head_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx ``[N, E]`` in x's dtype; ``gscale`` is dloss/N as a one-element
    fp32 tensor on the device (never read on the host)."""
    if x.device.type == "cpu":
        return ce_backward_dx_reference(x, head, labels, lse, gscale, vocab_size,
                                        head_b=head_b)
    if x.device.type != "cuda":
        raise ValueError(f"ce_backward_dx: no kernel for device {x.device}")
    dtype = _check_cuda("ce_backward_dx", x, head, labels, vocab_size, lse, gscale)
    N, E = x.shape
    bias = _check_bias("ce_backward_dx", head_b, head.shape[0], x.device)
    if wide_path(E, bias is not None):
        lib = builder.load_library()
        ld, chunks, ds = _wide_chunks(x, head)
        dx = torch.empty_like(x)
        acc = torch.empty((N, E) if len(chunks) > 1 else (0,), dtype=torch.float32,
                          device=x.device)
        for v0, first, last in chunks:
            _wide_ds(lib, x, head, labels, lse, gscale, bias, ds, None, vocab_size, v0, ld,
                     False, dtype)
            ce_backward_dx.launches += 1
            rc = lib.dst_ce_wide_dx(x.data_ptr(), head.data_ptr(), ds.data_ptr(),
                                    acc.data_ptr() if acc.numel() else None, dx.data_ptr(),
                                    N, E, head.shape[0], vocab_size, v0, ld, int(first),
                                    int(last), dtype, _stream(x))
            builder.check(lib, rc, "ce_backward_dx (product)")
            ce_backward_dx.launches += 1
        return dx
    active = _active_clusters(E, dtype, x.device.index if x.device.index is not None
                              else torch.cuda.current_device())
    tiles, splits = dx_grid(N, head.shape[0], x.dtype, active)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty(splits * tiles * BWD_ROWS[x.dtype] * E if splits > 1 else 0, **f32)
    counters = torch.zeros(tiles * BWD_MAX_CLUSTER, dtype=torch.int32, device=x.device)
    lib = builder.load_library()
    rc = lib.dst_ce_backward_dx(x.data_ptr(), head.data_ptr(), labels.data_ptr(),
                                lse.data_ptr(), gscale.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), counters.data_ptr(), N, E, head.shape[0],
                                vocab_size, splits, dtype, _stream(x))
    builder.check(lib, rc, "ce_backward_dx")
    ce_backward_dx.launches += 1
    return dx


ce_backward_dx.launches = 0


def ce_backward_dhead(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, gscale: torch.Tensor, vocab_size: int,
                      head_b: Optional[torch.Tensor] = None):
    """dhead ``[V, E]`` in head's dtype, summed over the rows by one
    cluster per 128 vocab rows (64 in fp32), or on the wide path by one
    block per 128 x 128 tile of a chunk (no atomics: deterministic).  With
    ``head_b``: (dhead, dbias), dbias in head_b's dtype."""
    if x.device.type == "cpu":
        return ce_backward_dhead_reference(x, head, labels, lse, gscale, vocab_size,
                                           head_b=head_b)
    if x.device.type != "cuda":
        raise ValueError(f"ce_backward_dhead: no kernel for device {x.device}")
    dtype = _check_cuda("ce_backward_dhead", x, head, labels, vocab_size, lse, gscale)
    N, E = x.shape
    V = head.shape[0]
    bias = _check_bias("ce_backward_dhead", head_b, V, x.device)
    dh = torch.empty_like(head)
    if wide_path(E, bias is not None):
        lib = builder.load_library()
        ld, chunks, ds = _wide_chunks(x, head)
        f32 = dict(dtype=torch.float32, device=x.device)
        colsum = torch.empty(-(-N // WIDE_TILE) * ld, **f32) if bias is not None else None
        db = torch.empty(V, **f32) if bias is not None else None
        for v0, _, _ in chunks:
            _wide_ds(lib, x, head, labels, lse, gscale, bias, ds, colsum, vocab_size, v0, ld,
                     True, dtype)
            ce_backward_dhead.launches += 1
            rc = lib.dst_ce_wide_dhead(x.data_ptr(), head.data_ptr(), ds.data_ptr(),
                                       None if colsum is None else colsum.data_ptr(),
                                       dh.data_ptr(), None if db is None else db.data_ptr(),
                                       N, E, V, vocab_size, v0, ld, dtype, _stream(x))
            builder.check(lib, rc, "ce_backward_dhead (product)")
            ce_backward_dhead.launches += 1
        return dh if head_b is None else (dh, db.to(head_b.dtype))
    lib = builder.load_library()
    rc = lib.dst_ce_backward_dhead(x.data_ptr(), head.data_ptr(), labels.data_ptr(),
                                   lse.data_ptr(), gscale.data_ptr(), dh.data_ptr(), N, E,
                                   head.shape[0], vocab_size, dtype, _stream(x))
    builder.check(lib, rc, "ce_backward_dhead")
    ce_backward_dhead.launches += 1
    return dh


ce_backward_dhead.launches = 0


class _CrossEntropy(torch.autograd.Function):
    """Mean nll; backward through the dx and dhead entry points (dhead's
    also gives dbias)."""

    @staticmethod
    def forward(ctx, x, head, head_b, labels, vocab_size):
        nll, lse = ce_forward(x, head, labels, vocab_size, head_b=head_b)
        ctx.save_for_backward(x, head, head_b, labels, lse)
        ctx.vocab_size = vocab_size
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        x, head, head_b, labels, lse = ctx.saved_tensors
        # d(mean)/d(nll_i) = g / N, as a device scalar
        gscale = (g.float() / x.shape[0]).reshape(1)
        dx = dh = db = None
        if ctx.needs_input_grad[0]:
            dx = ce_backward_dx(x, head, labels, lse, gscale, ctx.vocab_size, head_b=head_b)
        if ctx.needs_input_grad[1] or (head_b is not None and ctx.needs_input_grad[2]):
            dh = ce_backward_dhead(x, head, labels, lse, gscale, ctx.vocab_size,
                                       head_b=head_b)
            if head_b is not None:
                dh, db = dh
        return dx, dh, db, None, None


def cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, head_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token nll of ``x`` ``[N, E]`` against ``head`` ``[V, E]``
    (plus ``head_b`` ``[V]``) without materializing logits (counterpart of
    ``fused_cross_entropy``).  Differentiable in x, head and head_b."""
    return _CrossEntropy.apply(x, head, head_b, labels, vocab_size)


def reset_counts() -> None:
    """Zero every launch and plain-call counter of this module."""
    for fn in (ce_forward, ce_backward_dx, ce_backward_dhead):
        fn.launches = 0
    for fn in (ce_forward_reference, ce_backward_dx_reference, ce_backward_dhead_reference):
        fn.calls = 0
