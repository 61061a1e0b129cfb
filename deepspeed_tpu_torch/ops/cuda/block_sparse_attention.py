"""Block-sparse attention: hand-written CUDA kernels and their plain
PyTorch versions (counterpart of
``deepspeed_tpu/ops/pallas/block_sparse_attention.py``).

Layout is the framework's: q, k, v and o ``[B, S, H, D]``; the row
statistics lse and delta are fp32 ``[B, H, S]`` (the JAX kernels' ``[B, H,
S, 1]`` is a Mosaic tiling artefact).  The sparsity layout is a ``[H, nb,
nb]`` 0/1 numpy array (``ops/sparse_attention/sparsity_config.py``) with
blocks of ``S // nb`` tokens.  From it ``build_luts`` makes JAX's lookup
tables: the row LUT ``[H * nb, max_r]`` (the key blocks of each layout row,
ascending, padded with the last) with its counts ``[H, nb]``, and the
column LUT and counts likewise.  ``device_luts`` keeps them as int32
tensors once per layout and device, so no step copies a LUT from the host.
The forward and dQ kernels walk one work list made from the row LUT on
the host (``build_fwd_tasks``: each row's live key blocks, the causal
filter applied, longest first across heads); ``fwd_work`` keeps it on the
device once per layout, ``causal`` and device.  The dKV kernel walks a
work list made from the column LUT on the host
(``build_dkv_tasks``: each key block's live query blocks, long columns
split into near-equal runs, longest first); ``dkv_work`` keeps it on the
device with the kernel's workspace (fp32 partials of the split columns and
their arrival counters) once per layout, ``causal``, batch size and device.

Three entry points, one per TPU kernel, each with its plain version:

* ``block_sparse_forward`` -> (o, lse); replaces ``_fwd_kernel``
  (``ops/pallas/block_sparse_attention.py:116``);
* ``block_sparse_backward_dq`` -> dq; replaces ``_dq_kernel`` (``:195``);
* ``block_sparse_backward_dkv`` -> (dk, dv); replaces ``_dkv_kernel``
  (``:231``).

The plain versions (``*_reference``) follow the Pallas code literally: the
grid's walk over each row's (or column's) padded LUT becomes a gather of
the listed blocks, the entries past the count and, under ``causal``, the
keys past the query are ``-1e30``, and ``p = where(s <= -1e30 / 2, 0,
exp(...))``.  Inputs are upcast to fp32 and p and ds stay fp32, as in the
JAX kernels.  ``kernel_rounding=True`` rounds p to v's dtype before
``p . v`` (to do's before ``p^T . do``) and ds to q's dtype before ``ds .
k`` and ``ds^T . q``, as the bf16 kernels must for the tensor cores; in
fp32 it changes nothing.  A row with nothing listed gives o = 0, lse =
-1e30 and zero gradients.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel of ``csrc/block_sparse_attention.cu`` or raises on a dtype,
head_dim, block size, shape, layout or device the kernel does not take.
There is no fallback.  The kernels read q, k, v and do by strides (head_dim
contiguous, rows on 16-byte boundaries); o, dq, dk and dv come out
contiguous.  Kernel notes (bound, design) are in the ``.cu`` file.

``block_sparse_attention`` is differentiable in q, k and v through the
custom op ``dst_torch::block_sparse_fwd`` (returning o and lse over the
forward's work list; the column LUT and dKV's work list ride along as
inputs) and its registered backward, which hands dQ the forward's own work
list.
Activation checkpointing saves nothing of it, as the JAX policy saves only
flash's outputs, so under remat its forward runs twice per layer
(``runtime/activation_checkpointing/checkpointing.py``).

``sparse_reference_attention`` is the masked-dense path with rpe,
key-padding and attention masks; JAX computes it outside any kernel, so it
is plain torch here.

Each wrapper counts its launches (``block_sparse_forward.launches``); each
plain version counts its calls (``block_sparse_forward_reference.calls``).
"""

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import builder, capture

NEG_INF = -1e30
KERNEL_BLOCK = 64          # the one layout block size the kernels are compiled for
KERNEL_HEAD_DIM = 64       # and the one head_dim
OTHER_SHAPES = "ROADMAP.md, Queue 1 item 9 (sparse attention at other block sizes and head dims)"
FP16 = "ROADMAP.md, Queue 1 item 5 (fp16 training)"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Layout -> LUT
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=64)
def _luts_cached(layout_bytes: bytes, H: int, nb: int):
    layout = np.frombuffer(layout_bytes, dtype=np.int32).reshape(H, nb, nb)
    return _build_luts(layout)


def _build_luts(layout: np.ndarray):
    """Row and column LUTs from a [H, nb, nb] 0/1 layout.

    Returns (row_lut [H*nb, max_r], row_cnt [H, nb],
             col_lut [H*nb, max_c], col_cnt [H, nb]) as int32 numpy arrays.
    Padding entries repeat the last valid index (their compute is masked);
    fully-empty rows pad with 0.
    """
    H, nb, _ = layout.shape
    row_cnt = layout.sum(axis=2).astype(np.int32)
    col_cnt = layout.sum(axis=1).astype(np.int32)
    max_r = max(int(row_cnt.max()), 1)
    max_c = max(int(col_cnt.max()), 1)
    row_lut = np.zeros((H * nb, max_r), dtype=np.int32)
    col_lut = np.zeros((H * nb, max_c), dtype=np.int32)
    for h in range(H):
        for i in range(nb):
            cols = np.nonzero(layout[h, i])[0]
            row_lut[h * nb + i, :len(cols)] = cols
            if len(cols):
                row_lut[h * nb + i, len(cols):] = cols[-1]
            rows = np.nonzero(layout[h, :, i])[0]
            col_lut[h * nb + i, :len(rows)] = rows
            if len(rows):
                col_lut[h * nb + i, len(rows):] = rows[-1]
    return row_lut, row_cnt, col_lut, col_cnt


def _as_layout(layout) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(layout, dtype=np.int32))


def build_luts(layout: np.ndarray):
    layout = _as_layout(layout)
    H, nb, _ = layout.shape
    return _luts_cached(layout.tobytes(), H, nb)


@functools.lru_cache(maxsize=64)
def _device_luts_cached(layout_bytes: bytes, H: int, nb: int, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _luts_cached(layout_bytes, H, nb))


def device_luts(layout: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """``build_luts`` as int32 tensors on ``device``, made once per layout
    and device."""
    layout = _as_layout(layout)
    H, nb, _ = layout.shape
    return capture.hold(_device_luts_cached(layout.tobytes(), H, nb, str(torch.device(device))))


# --------------------------------------------------------------------------- #
# The forward's work list
# --------------------------------------------------------------------------- #
FWD_TASK_FIELDS = ("head", "query_block", "first", "count", "diagonal")


def build_fwd_tasks(row_lut: np.ndarray, row_cnt: np.ndarray, causal: bool):
    """The forward's work list, from the numpy row LUT of ``build_luts``.

    A task is one (head, query block) row's live key blocks: all it lists,
    or under ``causal`` those at or before the query block, ascending; a
    row with none is a task of count 0 (it writes o = 0, lse = -1e30).
    ``diagonal`` is 1 where the walk's last block is the query block itself
    under ``causal``, the one block the kernel masks by value.

    Returns ``(tasks, entries)``: ``tasks`` int32 ``[H * nb, 5]`` with the
    columns of ``FWD_TASK_FIELDS``, sorted by count, longest first (stably:
    ties by head, then query block); task i walks ``entries[first : first +
    count]``.
    """
    H, nb = row_cnt.shape
    rows, runs = [], []
    for h in range(H):
        for qb in range(nb):
            live = row_lut[h * nb + qb, :row_cnt[h, qb]]
            if causal:
                live = live[live <= qb]
            runs.append(live)
            rows.append([h, qb, 0, len(live), int(causal and len(live) > 0 and live[-1] == qb)])
    order = sorted(range(len(rows)), key=lambda i: -rows[i][3])
    tasks = np.asarray([rows[i] for i in order], np.int32).reshape(-1, len(FWD_TASK_FIELDS))
    counts = tasks[:, 3].astype(np.int64)
    tasks[:, 2] = np.cumsum(counts) - counts
    entries = np.concatenate([runs[i] for i in order] + [np.zeros(0, np.int32)])
    return tasks, entries.astype(np.int32)


class FwdWork(NamedTuple):
    """The forward's work list on a device (``build_fwd_tasks``)."""
    tasks: torch.Tensor       # int32 [H * nb, 5] (FWD_TASK_FIELDS)
    entries: torch.Tensor     # int32 [n_entries]


@functools.lru_cache(maxsize=64)
def _fwd_work_cached(layout_bytes: bytes, H: int, nb: int, causal: bool, device: str) -> FwdWork:
    row_lut, row_cnt, _, _ = _luts_cached(layout_bytes, H, nb)
    tasks, entries = build_fwd_tasks(row_lut, row_cnt, causal)
    return FwdWork(torch.from_numpy(tasks).to(device), torch.from_numpy(entries).to(device))


def fwd_work(layout: np.ndarray, causal: bool, device) -> FwdWork:
    """``build_fwd_tasks`` of the layout's row LUT on ``device``, made once
    per (layout, causal, device): the list does not depend on the batch,
    which the kernel's grid folds in."""
    layout = _as_layout(layout)
    H, nb, _ = layout.shape
    return capture.hold(_fwd_work_cached(layout.tobytes(), H, nb, bool(causal),
                                         str(torch.device(device))))


# --------------------------------------------------------------------------- #
# dKV's work list
# --------------------------------------------------------------------------- #
# the longest walk of one dKV task, in query blocks (a column that lists more
# is split): "auto" is the share of a launch's live tiles that falls to each
# block slot of the card (dkv_split), so a split shortens only walks longer
# than the launch's balanced length (PERF.md, section 6, has the fixed
# lengths measured beside it); an int fixes it, None splits nothing
DKV_SPLIT = "auto"
TASK_FIELDS = ("head", "key_block", "first", "count", "split", "splits", "slot", "counter")


def build_dkv_tasks(col_lut: np.ndarray, col_cnt: np.ndarray, causal: bool,
                    split: Optional[int]):
    """dKV's work list, from the numpy column LUT of ``build_luts``.

    A task is one key block's live query blocks (all it lists, or under
    ``causal`` those at or after it), in ascending order; a column with
    more than ``split`` of them (``None``: no limit) becomes ``ceil(n /
    split)`` tasks of consecutive runs of near-equal length, its splits.  A
    column with none is a task of count 0 (its dK and dV are zeros).

    Returns ``(tasks, entries, n_slots, n_counters)``: ``tasks`` int32
    ``[n_tasks, 8]`` with the columns of ``TASK_FIELDS``, sorted by count,
    longest first (stably: ties by head, key block, split); task i walks
    ``entries[first : first + count]``.  The splits of one column take
    consecutive partial slots (``slot - split`` is the column's first) of
    ``n_slots`` and one arrival counter of ``n_counters``; an unsplit task
    has slot and counter -1.
    """
    H, nb = col_cnt.shape
    rows, runs = [], []
    n_slots = n_counters = 0
    for h in range(H):
        for kb in range(nb):
            live = col_lut[h * nb + kb, :col_cnt[h, kb]]
            if causal:
                live = live[live >= kb]
            n = len(live)
            splits = -(-n // split) if split and n > split else 1
            cuts = [i * n // splits for i in range(splits + 1)]
            for sp in range(splits):
                runs.append(live[cuts[sp]:cuts[sp + 1]])
                rows.append([h, kb, 0, cuts[sp + 1] - cuts[sp], sp, splits,
                             n_slots + sp if splits > 1 else -1,
                             n_counters if splits > 1 else -1])
            if splits > 1:
                n_slots += splits
                n_counters += 1
    order = sorted(range(len(rows)), key=lambda i: -rows[i][3])
    tasks = np.asarray([rows[i] for i in order], np.int32).reshape(-1, len(TASK_FIELDS))
    counts = tasks[:, 3].astype(np.int64)
    tasks[:, 2] = np.cumsum(counts) - counts
    entries = np.concatenate([runs[i] for i in order] + [np.zeros(0, np.int32)])
    return tasks, entries.astype(np.int32), n_slots, n_counters


class DkvWork(NamedTuple):
    """dKV's work list on a device, with the kernel's workspace for one
    batch size: the split columns' fp32 partial dK and dV and their arrival
    counters (zero between launches: each launch leaves them so)."""
    tasks: torch.Tensor       # int32 [n_tasks, 8] (TASK_FIELDS)
    entries: torch.Tensor     # int32 [n_entries]
    partials: torch.Tensor    # fp32 [B, n_slots, 2, KERNEL_BLOCK * KERNEL_HEAD_DIM]
    counters: torch.Tensor    # int32 [B, n_counters]

    def workspace_bytes(self) -> int:
        """Bytes of the partials and counters."""
        return sum(t.numel() * t.element_size() for t in (self.partials, self.counters))


@functools.lru_cache(maxsize=16)
def _dkv_work_cached(layout_bytes: bytes, H: int, nb: int, causal: bool, batch: int,
                     device: str, split: Optional[int]) -> DkvWork:
    _, _, col_lut, col_cnt = _luts_cached(layout_bytes, H, nb)
    tasks, entries, n_slots, n_counters = build_dkv_tasks(col_lut, col_cnt, causal, split)
    return DkvWork(torch.from_numpy(tasks).to(device), torch.from_numpy(entries).to(device),
                   torch.zeros((batch, n_slots, 2, KERNEL_BLOCK * KERNEL_HEAD_DIM),
                               dtype=torch.float32, device=device),
                   torch.zeros((batch, n_counters), dtype=torch.int32, device=device))


def balanced_split(live_tiles: int, batch: int, slots: int) -> int:
    """The walk each of ``slots`` block slots would take if a launch's
    ``live_tiles x batch`` tiles were shared equally: ``ceil(live_tiles x
    batch / slots)``, at least 1."""
    return max(1, -(-live_tiles * batch // slots))


@functools.lru_cache(maxsize=None)
def _dkv_slots(device: str, dtype: torch.dtype, nb: int) -> int:
    """dKV blocks the card holds at once: SMs x blocks per SM (occupancy
    query)."""
    device = torch.device(device)
    with torch.cuda.device(device):
        blocks, _ = kernel_occupancy("dkv", dtype, nb)
    return torch.cuda.get_device_properties(device).multi_processor_count * blocks


def dkv_split(layout: np.ndarray, causal: bool, batch: int, device,
              dtype: torch.dtype = torch.bfloat16, split=DKV_SPLIT) -> Optional[int]:
    """The split length ``dkv_work`` uses: ``split`` itself, or for "auto"
    on a card ``balanced_split`` of the layout's live tiles over the dKV
    kernel's block slots (on the CPU, whose plain version walks the LUT,
    None)."""
    if split != "auto":
        return split
    if torch.device(device).type != "cuda":
        return None
    layout = _as_layout(layout)
    nb = layout.shape[-1]
    live = layout * np.tril(np.ones((nb, nb), np.int32)) if causal else layout
    return balanced_split(int(live.sum()), batch, _dkv_slots(str(device), dtype, nb))


def dkv_work(layout: np.ndarray, causal: bool, batch: int, device,
             dtype: torch.dtype = torch.bfloat16, split=DKV_SPLIT) -> DkvWork:
    """``build_dkv_tasks`` of the layout's column LUT on ``device`` at the
    split length ``dkv_split`` gives, with the workspace for ``batch``, made
    once per (layout, causal, batch, device, split length).  ``dtype`` is
    the kernel's (its blocks per SM set "auto"'s length).  Calls that share
    one must run on one stream."""
    layout = _as_layout(layout)
    split = dkv_split(layout, causal, batch, device, dtype, split)
    H, nb, _ = layout.shape
    return capture.hold(_dkv_work_cached(layout.tobytes(), H, nb, bool(causal), int(batch),
                                         str(torch.device(device)), split))


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def _blocks(x: torch.Tensor, nb: int) -> torch.Tensor:
    """``[B, S, H, ...]`` -> fp32 ``[B, H, nb, S // nb, ...]``."""
    B, S, H = x.shape[:3]
    return x.float().transpose(1, 2).reshape(B, H, nb, S // nb, *x.shape[3:])


def _gather(xb: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The blocks a LUT lists: ``xb`` ``[B, H, nb, bs, ...]`` -> ``[B, H, nb,
    n, bs, ...]``, entry ``[.., i, j, ..]`` being block ``lut[h * nb + i,
    j]`` of head h."""
    H, nb = xb.shape[1], xb.shape[2]
    idx = lut.long().reshape(H, nb, -1)
    heads = torch.arange(H, device=xb.device)[:, None, None]
    return xb[:, heads, idx]


def _keep(lut, cnt, causal: bool, bs: int, key_rows: bool) -> torch.Tensor:
    """``[H, nb, n, bs, bs]`` bool: the score entries the Pallas kernels
    compute and keep.  Entries past a row's count are skipped there (masked
    here); under ``causal`` a key past its query is masked.  Rows of a
    score tile are the block's own queries (keys when ``key_rows``: the
    column walk of dKV), columns the listed block's keys (queries)."""
    H, nb = cnt.shape
    n = lut.shape[1]
    idx = lut.long().reshape(H, nb, n)
    keep = (torch.arange(n, device=cnt.device) < cnt[..., None])[..., None, None]
    if causal:
        own = torch.arange(nb, device=cnt.device)[None, :, None, None, None] * bs
        listed = idx[..., None, None] * bs
        r = torch.arange(bs, device=cnt.device)
        if key_rows:       # [.., r, c]: r a query of the listed block, c a key of the own
            keep = keep & (listed + r[:, None] >= own + r[None, :])
        else:              # r a query of the own block, c a key of the listed
            keep = keep & (own + r[:, None] >= listed + r[None, :])
    return keep


def _unblock(x: torch.Tensor, dtype) -> torch.Tensor:
    """``[B, H, nb, bs, D]`` -> contiguous ``[B, S, H, D]`` in ``dtype``."""
    B, H, nb, bs, D = x.shape
    return x.reshape(B, H, nb * bs, D).transpose(1, 2).to(dtype).contiguous()


def _rounded(x: torch.Tensor, dtype, kernel_rounding: bool) -> torch.Tensor:
    return x.to(dtype).float() if kernel_rounding else x


def _row_probs(q, k, lut, cnt, causal, scale):
    """(masked scores ``[B, H, nb, n, bs, bs]`` of the row walk, the gathered
    k blocks)."""
    nb = cnt.shape[1]
    bs = q.shape[1] // nb
    kg = _gather(_blocks(k, nb), lut)
    s = torch.einsum("bhird,bhijcd->bhijrc", _blocks(q, nb), kg) * scale
    return torch.where(_keep(lut, cnt, causal, bs, False), s, NEG_INF), kg


def block_sparse_forward_reference(q, k, v, row_lut, row_cnt, causal: bool, scale: float,
                                   kernel_rounding: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype ``[B, S, H, D]``, lse fp32 ``[B, H, S]``)."""
    block_sparse_forward_reference.calls += 1
    B, S, H, _ = q.shape
    nb = row_cnt.shape[1]
    s, _ = _row_probs(q, k, row_lut, row_cnt, causal, scale)
    m = s.amax(dim=(3, 5)).clamp(min=NEG_INF)                          # [B, H, nb, bs]
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m[:, :, :, None, :, None]))
    l_safe = p.sum(dim=(3, 5)).clamp(min=1e-30)
    vg = _gather(_blocks(v, nb), row_lut)
    pv = torch.einsum("bhijrc,bhijcd->bhird", _rounded(p, v.dtype, kernel_rounding), vg)
    o = _unblock(pv / l_safe[..., None], q.dtype)
    return o, (m + torch.log(l_safe)).reshape(B, H, S)


block_sparse_forward_reference.calls = 0


def block_sparse_backward_dq_reference(q, k, v, do, lse, delta, row_lut, row_cnt, causal: bool,
                                       scale: float, kernel_rounding: bool = False
                                       ) -> torch.Tensor:
    """dq ``[B, S, H, D]`` in q's dtype, against the given lse and delta
    (``rowsum(do * o)``), fp32 ``[B, H, S]``."""
    block_sparse_backward_dq_reference.calls += 1
    B, S, H, _ = q.shape
    nb = row_cnt.shape[1]
    s, kg = _row_probs(q, k, row_lut, row_cnt, causal, scale)
    lse_b, delta_b = (t.reshape(B, H, nb, 1, S // nb, 1) for t in (lse, delta))
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse_b))
    dp = torch.einsum("bhird,bhijcd->bhijrc", _blocks(do, nb), _gather(_blocks(v, nb), row_lut))
    ds = p * (dp - delta_b) * scale
    dq = torch.einsum("bhijrc,bhijcd->bhird", _rounded(ds, q.dtype, kernel_rounding), kg)
    return _unblock(dq, q.dtype)


block_sparse_backward_dq_reference.calls = 0


def block_sparse_backward_dkv_reference(q, k, v, do, lse, delta, col_lut, col_cnt, causal: bool,
                                        scale: float, kernel_rounding: bool = False
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``[B, S, H, D]`` in k's and v's dtypes, over the column LUT."""
    block_sparse_backward_dkv_reference.calls += 1
    B, S, H, _ = q.shape
    nb = col_cnt.shape[1]
    bs = S // nb
    qg = _gather(_blocks(q, nb), col_lut)                               # [B, H, nb, n, bs, D]
    dog = _gather(_blocks(do, nb), col_lut)
    lse_g, delta_g = (_gather(t.reshape(B, H, nb, bs), col_lut)[..., None] for t in (lse, delta))
    s = torch.einsum("bhjird,bhjcd->bhjirc", qg, _blocks(k, nb)) * scale
    s = torch.where(_keep(col_lut, col_cnt, causal, bs, True), s, NEG_INF)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse_g))
    dv = torch.einsum("bhjirc,bhjird->bhjcd", _rounded(p, do.dtype, kernel_rounding), dog)
    dp = torch.einsum("bhjird,bhjcd->bhjirc", dog, _blocks(v, nb))
    ds = p * (dp - delta_g) * scale
    dk = torch.einsum("bhjirc,bhjird->bhjcd", _rounded(ds, q.dtype, kernel_rounding), qg)
    return _unblock(dk, k.dtype), _unblock(dv, v.dtype)


block_sparse_backward_dkv_reference.calls = 0


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check(name: str, q, k, v, lut, cnt, do=None, lse=None, delta=None) -> int:
    """Validate what the kernels take; returns the dtype code."""
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"{name}: q, k and v must be one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernels are compiled for head_dim "
                         f"{KERNEL_HEAD_DIM}, got {D} ({OTHER_SHAPES})")
    if cnt.dim() != 2 or cnt.shape[0] != H or S % cnt.shape[1]:
        raise ValueError(f"{name}: LUT counts {tuple(cnt.shape)} do not fit [H={H}, nb] "
                         f"blocks of seq {S}")
    nb = cnt.shape[1]
    if S // nb != KERNEL_BLOCK:
        raise ValueError(f"{name}: the CUDA kernels are compiled for layout block "
                         f"{KERNEL_BLOCK}, got {S // nb} ({OTHER_SHAPES})")
    if (lut.dim() != 2 or lut.shape[0] != H * nb or not 0 < lut.shape[1] <= nb
            or lut.dtype != torch.int32 or cnt.dtype != torch.int32
            or not lut.is_contiguous() or not cnt.is_contiguous()):
        raise TypeError(f"{name}: the LUT must be contiguous int32 [{H * nb}, n <= {nb}] with "
                        f"int32 counts [{H}, {nb}], got {lut.dtype} {tuple(lut.shape)}")
    if B > 65535 or H > 65535 or B * S * H * D >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(q.shape)} out of range")
    inputs = (q, k, v) + ((do,) if do is not None else ())
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in inputs):
        raise TypeError(f"{name}: CUDA kernels take float32 or bfloat16 q, k, v"
                        f"{', do' if do is not None else ''} of one dtype, got "
                        f"{[str(t.dtype) for t in inputs]}"
                        + (f" (float16 is not ported yet: {FP16})"
                           if any(t.dtype == torch.float16 for t in inputs) else ""))
    if do is not None and tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: do {tuple(do.shape)} must match q {tuple(q.shape)}")
    for stat in (lse, delta):
        if stat is not None and (stat.dtype != torch.float32 or tuple(stat.shape) != (B, H, S)
                                 or not stat.is_contiguous()):
            raise TypeError(f"{name}: lse and delta must be contiguous fp32 [{B}, {H}, {S}]")
    tensors = [t for t in (q, k, v, do, lse, delta, lut, cnt) if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"{name}: no kernel for devices {devices}")
    vec = 16 // q.element_size()
    for t in inputs:
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: CUDA kernels take head_dim contiguous and rows, heads "
                             f"and batches on 16-byte boundaries; got strides {t.stride()}")
    return _DTYPE_CODES[q.dtype]


def _strides(q, k, v, do):
    """The kernels' stride table: (b, s, h) of q, k, v and do."""
    vals = [st for t in (q, k, v) for st in t.stride()[:3]]
    vals += list(do.stride()[:3]) if do is not None else [0, 0, 0]
    return (ctypes.c_longlong * 12)(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_fwd_work(work: Optional[FwdWork], H: int, nb: int, device,
                    name: str = "block_sparse_forward") -> None:
    """What the forward and dQ kernels take of their work list
    (``fwd_work``)."""
    if work is None:
        raise ValueError(f"{name}: the CUDA kernel walks a work list: pass work=fwd_work(layout, "
                         "causal, device)")
    tasks, entries = work
    ok = (tasks.dtype == entries.dtype == torch.int32 and all(t.is_contiguous() for t in work)
          and all(t.device == device for t in work)
          and tuple(tasks.shape) == (H * nb, len(FWD_TASK_FIELDS)))
    if not ok:
        raise ValueError(f"{name}: work must be fwd_work of this layout on {device}")


def block_sparse_forward(q, k, v, row_lut, row_cnt, causal: bool, scale: float,
                         work: Optional[FwdWork] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o ``[B, S, H, D]`` in q's dtype, lse fp32 ``[B, H, S]``) over the
    row LUT.  CPU tensors take the plain version; on CUDA the kernel walks
    ``work`` (``fwd_work`` of the same layout and ``causal``)."""
    if q.device.type == "cpu":
        return block_sparse_forward_reference(q, k, v, row_lut, row_cnt, causal, scale)
    dtype = _check("block_sparse_forward", q, k, v, row_lut, row_cnt)
    B, S, H, _ = q.shape
    _check_fwd_work(work, H, row_cnt.shape[1], q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = builder.load_library()
    rc = lib.dst_sparse_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), work.tasks.data_ptr(),
                                work.entries.data_ptr(), work.tasks.shape[0], o.data_ptr(),
                                lse.data_ptr(), _strides(q, k, v, None), B, S, H, scale,
                                int(causal), dtype, _stream(q))
    builder.check(lib, rc, "block_sparse_forward")
    block_sparse_forward.launches += 1
    return o, lse


block_sparse_forward.launches = 0


def block_sparse_backward_dq(q, k, v, do, lse, delta, row_lut, row_cnt, causal: bool,
                             scale: float, work: Optional[FwdWork] = None) -> torch.Tensor:
    """dq ``[B, S, H, D]`` in q's dtype over the row LUT.  CPU tensors take
    the plain version; on CUDA the kernel walks ``work``, the forward's work
    list (``fwd_work`` of the same layout and ``causal``)."""
    if q.device.type == "cpu":
        return block_sparse_backward_dq_reference(q, k, v, do, lse, delta, row_lut, row_cnt,
                                                  causal, scale)
    name = "block_sparse_backward_dq"
    dtype = _check(name, q, k, v, row_lut, row_cnt, do, lse, delta)
    B, S, H, _ = q.shape
    _check_fwd_work(work, H, row_cnt.shape[1], q.device, name)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = builder.load_library()
    rc = lib.dst_sparse_backward_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), work.tasks.data_ptr(),
                                    work.entries.data_ptr(), work.tasks.shape[0], dq.data_ptr(),
                                    _strides(q, k, v, do), B, S, H, scale, int(causal), dtype,
                                    _stream(q))
    builder.check(lib, rc, "block_sparse_backward_dq")
    block_sparse_backward_dq.launches += 1
    return dq


block_sparse_backward_dq.launches = 0


def _check_work(work: Optional[DkvWork], B: int, H: int, nb: int, device) -> None:
    """What the dKV kernel takes of its work list (``dkv_work``)."""
    name = "block_sparse_backward_dkv"
    if work is None:
        raise ValueError(f"{name}: the CUDA kernel walks a work list: pass work=dkv_work(layout, "
                         "causal, batch, device, dtype)")
    tasks, entries, partials, counters = work
    ok = (tasks.dtype == entries.dtype == counters.dtype == torch.int32
          and partials.dtype == torch.float32 and all(t.is_contiguous() for t in work)
          and all(t.device == device for t in work)
          and tasks.dim() == 2 and tasks.shape[1] == len(TASK_FIELDS) and tasks.shape[0] >= H * nb
          and partials.dim() == 4 and partials.shape[0] == B
          and tuple(partials.shape[2:]) == (2, KERNEL_BLOCK * KERNEL_HEAD_DIM)
          and counters.dim() == 2 and counters.shape[0] == B and tasks.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(f"{name}: work must be dkv_work of this layout for batch {B} on {device}")


def block_sparse_backward_dkv(q, k, v, do, lse, delta, col_lut, col_cnt, causal: bool,
                              scale: float, work: Optional[DkvWork] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``[B, S, H, D]`` in k's and v's dtypes over the column LUT.
    CPU tensors take the plain version; on CUDA the kernel walks ``work``
    (``dkv_work`` of the same layout, ``causal`` and batch size)."""
    if q.device.type == "cpu":
        return block_sparse_backward_dkv_reference(q, k, v, do, lse, delta, col_lut, col_cnt,
                                                   causal, scale)
    dtype = _check("block_sparse_backward_dkv", q, k, v, col_lut, col_cnt, do, lse, delta)
    B, S, H, _ = q.shape
    _check_work(work, B, H, col_cnt.shape[1], q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = builder.load_library()
    rc = lib.dst_sparse_backward_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                     lse.data_ptr(), delta.data_ptr(), work.tasks.data_ptr(),
                                     work.entries.data_ptr(), work.tasks.shape[0],
                                     work.partials.data_ptr(), work.partials.shape[1],
                                     work.counters.data_ptr(), work.counters.shape[1],
                                     dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do), B, S,
                                     H, scale, int(causal), dtype, _stream(q))
    builder.check(lib, rc, "block_sparse_backward_dkv")
    block_sparse_backward_dkv.launches += 1
    return dk, dv


block_sparse_backward_dkv.launches = 0

_KERNEL_CODES = {"forward": 0, "dq": 1, "dkv": 2}


def kernel_occupancy(kernel: str, dtype: torch.dtype, nb: int) -> Tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of one
    block-sparse kernel ("forward", "dq" or "dkv") on the current card at
    ``nb`` layout blocks, by CUDA's occupancy query.  Launches nothing."""
    if kernel not in _KERNEL_CODES or dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel_occupancy: no kernel {kernel!r} for {dtype}")
    lib = builder.load_library()
    smem = ctypes.c_int(0)
    blocks = lib.dst_sparse_occupancy(_KERNEL_CODES[kernel], _DTYPE_CODES[dtype], nb,
                                      ctypes.byref(smem))
    if blocks <= 0:
        raise RuntimeError(f"kernel_occupancy: the occupancy query failed for {kernel}")
    return blocks, smem.value


# --------------------------------------------------------------------------- #
# The differentiable op
# --------------------------------------------------------------------------- #
@torch.library.custom_op("dst_torch::block_sparse_fwd", mutates_args=())
def block_sparse_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        row_lut: torch.Tensor, row_cnt: torch.Tensor, col_lut: torch.Tensor,
                        col_cnt: torch.Tensor, fwd_tasks: torch.Tensor,
                        fwd_entries: torch.Tensor, dkv_tasks: torch.Tensor,
                        dkv_entries: torch.Tensor,
                        dkv_partials: torch.Tensor, dkv_counters: torch.Tensor, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of ``block_sparse_forward`` over its work list (``FwdWork``'s
    two tensors), as one dispatcher op; the column LUT and dKV's work list
    (``DkvWork``'s four tensors) ride along for the backward."""
    return block_sparse_forward(q, k, v, row_lut, row_cnt, causal, scale,
                                work=FwdWork(fwd_tasks, fwd_entries))


@block_sparse_fwd_op.register_fake
def _block_sparse_fwd_fake(q, k, v, row_lut, row_cnt, col_lut, col_cnt, fwd_tasks,
                           fwd_entries, dkv_tasks, dkv_entries, dkv_partials, dkv_counters,
                           causal, scale):
    B, S, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, S), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, row_lut, row_cnt, col_lut, col_cnt = inputs[:7]
    causal, scale = inputs[13:]
    o, lse = output
    ctx.save_for_backward(q, k, v, row_lut, row_cnt, col_lut, col_cnt, o, lse)
    # the forward's own work list for dQ (the tensors it ran), dKV's for dKV
    ctx.fwd_work = FwdWork(*inputs[7:9])
    ctx.work = DkvWork(*inputs[9:13])
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, do, _dlse):
    q, k, v, row_lut, row_cnt, col_lut, col_cnt, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()      # [B, H, S]
    dq = block_sparse_backward_dq(q, k, v, do, lse, delta, row_lut, row_cnt, ctx.causal,
                                  ctx.scale, work=ctx.fwd_work)
    dk, dv = block_sparse_backward_dkv(q, k, v, do, lse, delta, col_lut, col_cnt, ctx.causal,
                                       ctx.scale, work=ctx.work)
    return (dq, dk, dv) + (None,) * 12


block_sparse_fwd_op.register_autograd(_backward, setup_context=_setup_context)


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #
def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout: np.ndarray, *, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention over a static sparsity layout, differentiable
    in q, k and v.

    Args:
      q, k, v: ``[batch, seq, heads, head_dim]``, one shape.
      layout: ``[heads, seq//block, seq//block]`` 0/1 numpy array from a
        :class:`~deepspeed_tpu_torch.ops.sparse_attention.SparsityConfig`;
        the block size is inferred as ``seq // layout.shape[-1]``.
      causal: apply the elementwise triangular mask on top of the layout.
      scale: logit scale; defaults to ``1/sqrt(head_dim)``.
    """
    B, S, H, D = q.shape
    layout = _as_layout(layout)
    if layout.ndim != 3 or layout.shape[0] != H:
        raise ValueError(f"layout must be [heads={H}, nb, nb], got {layout.shape}")
    nb = layout.shape[-1]
    if S % nb != 0:
        raise ValueError(f"seq {S} not divisible into {nb} layout blocks")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k and v must share one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o, _ = block_sparse_fwd_op(q, k, v, *device_luts(layout, q.device),
                               *fwd_work(layout, causal, q.device),
                               *dkv_work(layout, causal, B, q.device, q.dtype), causal,
                               float(scale))
    return o


def sparse_reference_attention(q, k, v, layout: np.ndarray, *,
                               causal: bool = False,
                               scale: Optional[float] = None,
                               rpe=None, key_padding_mask=None, attn_mask=None,
                               key_padding_mask_mode: str = "add",
                               attn_mask_mode: str = "mul"):
    """Masked-dense reference (and fully general path), plain torch.

    ``rpe`` is added to the logits; masks either add (``'add'``) or
    multiply-as-keep (``'mul'``, 0 -> masked).  Layout blocks that are 0
    never contribute probability mass.
    """
    B, S, H, D = q.shape
    nb = layout.shape[-1]
    bs = S // nb
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    mask = torch.from_numpy(np.kron(np.asarray(layout, np.float32),
                                    np.ones((bs, bs), np.float32))).to(q.device)  # [H, S, S]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if rpe is not None:
        s = s + rpe.float()
    if attn_mask is not None:
        am = attn_mask.float()
        s = s + am if attn_mask_mode == "add" else torch.where(am != 0, s, NEG_INF)
    if key_padding_mask is not None:
        kp = key_padding_mask.float()[:, None, None, :]                  # [B, 1, 1, S]
        s = s + kp if key_padding_mask_mode == "add" else torch.where(kp != 0, s, NEG_INF)
    if causal:
        tri = torch.ones(S, S, device=q.device).tril()
        s = torch.where(tri != 0, s, NEG_INF)
    s = torch.where(mask[None] != 0, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m.clamp(min=NEG_INF / 2))
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def reset_counts() -> None:
    """Zero every launch and plain-call counter of this module."""
    for fn in (block_sparse_forward, block_sparse_backward_dq, block_sparse_backward_dkv):
        fn.launches = 0
    for fn in (block_sparse_forward_reference, block_sparse_backward_dq_reference,
               block_sparse_backward_dkv_reference):
        fn.calls = 0
