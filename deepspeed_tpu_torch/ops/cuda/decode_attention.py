"""KV-cache decode attention: hand-written CUDA kernels and their plain
PyTorch versions (counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``).

Layouts are the JAX package's: q ``[B, S_q, H, D]``; the paged arena
``[NB, BS, Hkv, D]`` per layer (block 0 is the shared trash block) with
``block_tables`` ``[B, MB]`` int32 and ``lengths`` ``[B]`` int32; the
contiguous cache ``[B, T, Hkv, D]`` with a scalar ``pos``.  Query ``i`` of
row ``b`` sits at global position ``lengths[b] + i`` (or ``pos + i``) and
attends causally.  Query head ``h`` reads kv head ``h // (H / Hkv)``
(grouped-query attention against the un-expanded cache).  ``alibi``, per-head
slopes ``[H]`` fp32, adds ``slope_h * (key position - query position)`` to
each scaled score (BLOOM); on the card the kernels add it themselves, so no
``[B, H, S_q, T]`` bias is ever made.

Dispatch, for both entry points:

* a CPU tensor goes to the plain version (``*_reference``);
* a CUDA tensor launches the kernel of ``csrc/decode_attention.cu``, or
  raises on a dtype, shape or layout the kernel does not take.  There is no
  fallback from one to the other.

Kernel notes (details in the ``.cu`` file):

* ``paged_attention`` replaces ``_paged_kernel``
  (``ops/pallas/decode_attention.py:230``), ``decode_attention`` replaces
  ``_decode_kernel`` (``:78``).
* Both are bound by bytes: the live K/V read once, ~4 flops per element;
  the floor is live K/V bytes / 3.35 TB/s on an H100 SXM.
* Compiled for head_dim 64 (GPT-2), 96 (GPT-NeoX-20B), 128 (the LLaMA and
  BLOOM widths users serve) and 256 (GPT-J), and arena blocks of 16 keys
  (the serving arena's default block size).  Any other head_dim or block
  size raises on CUDA, and so does a dense ``bias`` tensor (``alibi``
  slopes are what the kernels take).
* Each call launches one kernel, of one of two paths picked by ``S_q``
  alone (``DECODE_MAX_ROWS``):

  - decode (``S_q <= 4``, every decode step): one block of 8 warps per
    (row, head); the row's live 16-key blocks are dealt to the warps round
    robin (block n to warp n % 8), so all 8 warps stream one row's keys at
    once, each with 16-byte ``cp.async`` copies into its own ring of 1-3
    blocks (16 KB a warp; fp32 at head_dim 256 in halves of 8 keys), which
    is what a bytes-bound kernel needs; each
    warp keeps its own online-softmax state and the 8 are merged at the
    end in a fixed order.
  - prefill (``S_q > 4``, prompt chunks): 64-query tiles on tensor cores
    (bf16 ``mma.sync``; fp32 by FMA, no TF32); the tile's 64-key tiles are
    dealt round robin to a cluster of 4 blocks, double buffered in shared
    memory, and merged through distributed shared memory; key tiles wholly
    past a query tile are skipped, so a prompt's early rows never read the
    keys they cannot see.

* The split of the keys over warps and tiles depends only on absolute key
  positions, and the two kernels differ only in how a key row is addressed
  (a block-table lookup or a stride), so for the same ``q`` and the
  gathered cache they take the same path and agree bit for bit in fp32.
  Within a path a row's result depends only on its position and the keys,
  so a prompt prefilled whole (``generate()``) and in chunks (the serving
  engine) gives the same rows.

Each wrapper counts its kernel launches in a plain int attribute
(``paged_attention.launches``); each plain version counts its calls
(``paged_attention_reference.calls``).
"""

import math
from typing import Optional

import torch

NEG_INF = -1e30
OTHER_HEAD_DIMS = "ROADMAP.md, Queue 2 part A: decode kernels at other head_dims"
KERNEL_TILE = 16         # keys per kernel tile = the paged arena's block_size
KERNEL_HEAD_DIMS = (64, 96, 128, 256)   # the head_dims the kernels are compiled for
DECODE_MAX_ROWS = 4      # S_q up to this takes the kernels' decode path
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions (ports of decode_attention_reference :168 and
# paged_attention_reference :193)
# --------------------------------------------------------------------------- #
def _grouped_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                       qpos: torch.Tensor, alibi: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, S_q, H, D]`` against the gathered cache ``[B, T, Hkv, D]``,
    grouped (no K/V expansion); ``qpos`` ``[B or 1, S_q]`` each query's
    position.  Scores: ``q . k / sqrt(D)`` in fp32, plus the ALiBi term
    and ``bias`` ``[B, H, S_q, T]``, masked past each query's position."""
    B, Sq, H, D = q.shape
    T, Hkv = ck.shape[1], ck.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ck.float()) * (1.0 / math.sqrt(D))
    kpos = torch.arange(T, device=q.device)
    if alibi is not None:
        dist = (kpos[None, None, :] - qpos[:, :, None]).float()   # [B, Sq, T]
        s = s + (alibi.float().reshape(Hkv, G)[None, :, :, None, None]
                 * dist[:, None, None])
    if bias is not None:
        s = s + bias.float().reshape(bias.shape[0], Hkv, G, *bias.shape[2:])
    mask = kpos[None, None, :] <= qpos[:, :, None]                # [B, Sq, T]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), cv)
    return out.reshape(B, Sq, H, D)


def decode_attention_reference(q: torch.Tensor, ck: torch.Tensor,
                               cv: torch.Tensor, pos: int,
                               alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-cache decode attention: q ``[B, S_q, H, D]`` against cache
    ``[B, T, Hkv, D]``, query ``i`` at position ``pos + i`` (JAX's
    ``decode_attention_reference``, and its ``_cached_attention`` for GQA
    and ALiBi)."""
    decode_attention_reference.calls += 1
    qpos = int(pos) + torch.arange(q.shape[1], device=q.device)[None]
    return _grouped_attention(q, ck, cv, qpos, alibi)


decode_attention_reference.calls = 0


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_tables: torch.Tensor,
                              lengths: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged attention through the block tables, GQA-aware (grouped against
    the un-expanded ``Hkv`` pages).  ``bias``: optional additive
    ``[B, H, S_q, MB*BS]`` logit bias; ``alibi``: per-head slopes ``[H]``
    (the same bias made from positions)."""
    paged_attention_reference.calls += 1
    B, Sq, H, D = q.shape
    NB, BS, Hkv, _ = k_pages.shape
    T = block_tables.shape[1] * BS
    tables = block_tables.long()
    # [B, MB, BS, Hkv, D] -> [B, T, Hkv, D]: the sequence's logical positions
    ck = k_pages[tables].reshape(B, T, Hkv, D)
    cv = v_pages[tables].reshape(B, T, Hkv, D)
    qpos = lengths.long()[:, None] + torch.arange(Sq, device=q.device)[None]
    return _grouped_attention(q, ck, cv, qpos, alibi, bias)


paged_attention_reference.calls = 0


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check_cuda(name: str, q: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Validate what the kernel takes; returns its dtype code."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: CUDA kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for t in (q,) + tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, "
                             f"got one on {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q is {q.dtype} but a K/V tensor is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA kernel takes contiguous tensors")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K/V tensors must start on a 16-byte "
                             "boundary (the kernel loads 16 bytes at a time)")
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel is compiled for head_dim "
                         f"{', '.join(map(str, KERNEL_HEAD_DIMS))}, got {D} "
                         f"({OTHER_HEAD_DIMS})")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: batch {q.shape[0]} > 65535")
    return _DTYPE_CODES[q.dtype]


def _check_alibi(name: str, alibi: Optional[torch.Tensor], q: torch.Tensor) -> int:
    """The slopes' pointer for the kernel (0: no ALiBi)."""
    if alibi is None:
        return 0
    H = q.shape[2]
    if (alibi.device != q.device or alibi.dtype != torch.float32
            or tuple(alibi.shape) != (H,) or not alibi.is_contiguous()):
        raise ValueError(f"{name}: alibi must be contiguous float32 [{H}] slopes "
                         f"on {q.device}, got {alibi.dtype} {tuple(alibi.shape)} "
                         f"on {alibi.device}")
    return alibi.data_ptr()


def _check_index(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name}: index tensors must be contiguous int32 on "
                        f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: index tensor shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-table KV attention for the serving engine (``[B, S_q, H, D]``
    out, q's dtype).  CPU tensors take the plain version, with ``bias`` or
    ``alibi``; on the card ALiBi is ``alibi`` and a dense ``bias`` raises."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, bias=bias, alibi=alibi)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    if bias is not None:
        raise NotImplementedError(
            "paged_attention: a dense additive bias has no CUDA kernel; pass "
            "ALiBi as alibi= slopes (ROADMAP.md, Queue 2 part A)")
    name = "paged_attention"
    dtype = _check_cuda(name, q, k_pages, v_pages)
    B, Sq, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pages must be [NB, BS, Hkv, D] and alike, "
                         f"got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    NB, BS, Hkv, Dk = k_pages.shape
    if Dk != D or H % Hkv != 0:
        raise ValueError(f"{name}: q heads/dim {H}/{D} do not fit pages "
                         f"Hkv/D {Hkv}/{Dk}")
    if BS != KERNEL_TILE:
        raise ValueError(f"{name}: the CUDA kernel is compiled for block_size "
                         f"{KERNEL_TILE}, got {BS}")
    if block_tables.dim() != 2:
        raise ValueError(f"{name}: block_tables must be [B, MB]")
    MB = block_tables.shape[1]
    _check_index(name, block_tables, (B, MB), q.device)
    _check_index(name, lengths, (B,), q.device)
    slopes = _check_alibi(name, alibi, q)
    from deepspeed_tpu_torch.ops.cuda import builder
    lib = builder.load_library()
    out = torch.empty_like(q)
    rc = lib.dst_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), slopes, out.data_ptr(),
        B, Sq, H, Hkv, D, BS, MB, 1.0 / math.sqrt(D), dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    builder.check(lib, rc, name)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: int, alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KV-cache attention for generate()'s prefill and decode
    (``[B, S_q, H, D]`` out, q's dtype) against the ``[B, T, Hkv, D]``
    cache.  The kernel splits the keys at the serving arena's block size,
    ``KERNEL_TILE``, as ``paged_attention`` does, so the two agree bit for
    bit in fp32.  Any ``T`` is taken; the ragged last tile is masked.  CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, ck, cv, pos, alibi=alibi)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    name = "decode_attention"
    dtype = _check_cuda(name, q, ck, cv)
    B, Sq, H, D = q.shape
    if ck.dim() != 4 or ck.shape != cv.shape or ck.shape[0] != B \
            or H % ck.shape[2] or ck.shape[3] != D:
        raise ValueError(f"{name}: cache must be [B, T, Hkv, D] = "
                         f"[{B}, T, a divisor of {H}, {D}], got {tuple(ck.shape)}")
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"{name}: pos {pos} < 0")
    slopes = _check_alibi(name, alibi, q)
    from deepspeed_tpu_torch.ops.cuda import builder
    lib = builder.load_library()
    out = torch.empty_like(q)
    rc = lib.dst_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), slopes, out.data_ptr(),
        B, Sq, H, ck.shape[2], D, ck.shape[1], pos, 1.0 / math.sqrt(D), dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    builder.check(lib, rc, name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def reset_counts() -> None:
    """Zero every launch and plain-call counter of this module."""
    paged_attention.launches = 0
    decode_attention.launches = 0
    paged_attention_reference.calls = 0
    decode_attention_reference.calls = 0
