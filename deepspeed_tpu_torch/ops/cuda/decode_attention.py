"""KV-cache decode attention: hand-written CUDA kernels and their plain
PyTorch versions (counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``).

Layouts are the JAX package's: q ``[B, S_q, H, D]``; the paged arena
``[NB, BS, Hkv, D]`` per layer (block 0 is the shared trash block) with
``block_tables`` ``[B, MB]`` int32 and ``lengths`` ``[B]`` int32; the
contiguous cache ``[B, T, H, D]`` with a scalar ``pos``.  Query ``i`` of row
``b`` sits at global position ``lengths[b] + i`` (or ``pos + i``) and
attends causally.

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
* Compiled for the GPT-2 family's shape only: head_dim 64, arena blocks of
  16 keys (the serving arena's default block size).  Any other head_dim or
  block size raises on CUDA.
* Each call launches one kernel, of one of two paths picked by ``S_q``
  alone (``DECODE_MAX_ROWS``):

  - decode (``S_q <= 4``, every decode step): one block of 8 warps per
    (row, head); the row's live 16-key blocks are dealt to the warps round
    robin (block n to warp n % 8), so all 8 warps stream one row's keys at
    once, each with 16-byte ``cp.async`` copies into its own 2-3 block
    ring, which is what a bytes-bound kernel needs; each warp keeps its own
    online-softmax state and the 8 are merged at the end in a fixed order.
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
KERNEL_TILE = 16         # keys per kernel tile = the paged arena's block_size
KERNEL_HEAD_DIM = 64     # the one head_dim the kernels are compiled for
DECODE_MAX_ROWS = 4      # S_q up to this takes the kernels' decode path
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions (ports of decode_attention_reference :168 and
# paged_attention_reference :193)
# --------------------------------------------------------------------------- #
def decode_attention_reference(q: torch.Tensor, ck: torch.Tensor,
                               cv: torch.Tensor, pos: int) -> torch.Tensor:
    """Full-cache decode attention: q ``[B, S_q, H, D]`` against cache
    ``[B, T, H, D]``, query ``i`` at position ``pos + i``."""
    decode_attention_reference.calls += 1
    B, Sq, H, D = q.shape
    T = ck.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    kpos = torch.arange(T, device=q.device)[None, :]
    qpos = int(pos) + torch.arange(Sq, device=q.device)[:, None]
    s = torch.where((kpos <= qpos)[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), cv)


decode_attention_reference.calls = 0


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_tables: torch.Tensor,
                              lengths: torch.Tensor,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged attention through the block tables, GQA-aware (grouped against
    the un-expanded ``Hkv`` pages).  ``bias``: optional additive
    ``[B, H, S_q, MB*BS]`` logit bias (ALiBi)."""
    paged_attention_reference.calls += 1
    B, Sq, H, D = q.shape
    NB, BS, Hkv, _ = k_pages.shape
    MB = block_tables.shape[1]
    T = MB * BS
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    tables = block_tables.long()
    # [B, MB, BS, Hkv, D] -> [B, T, Hkv, D]: the sequence's logical positions
    ck = k_pages[tables].reshape(B, T, Hkv, D)
    cv = v_pages[tables].reshape(B, T, Hkv, D)
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ck.float()) * scale
    if bias is not None:
        s = s + bias.float().reshape(bias.shape[0], Hkv, G, *bias.shape[2:])
    kpos = torch.arange(T, device=q.device)[None, None, :]
    qpos = (lengths.long()[:, None, None]
            + torch.arange(Sq, device=q.device)[None, :, None])
    mask = kpos <= qpos                                   # [B, Sq, T]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), cv)
    return out.reshape(B, Sq, H, D)


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
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel is compiled for head_dim "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: batch {q.shape[0]} > 65535")
    return _DTYPE_CODES[q.dtype]


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
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-table KV attention for the serving engine (``[B, S_q, H, D]``
    out, q's dtype).  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    if bias is not None:
        raise NotImplementedError(
            "paged_attention: an additive bias (ALiBi) has no CUDA kernel "
            "yet (ROADMAP.md, Queue 1: other GPT families)")
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
    from deepspeed_tpu_torch.ops.cuda import builder
    lib = builder.load_library()
    out = torch.empty_like(q)
    rc = lib.dst_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Sq, H, Hkv, D, BS, MB, 1.0 / math.sqrt(D), dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    builder.check(lib, rc, name)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: int) -> torch.Tensor:
    """KV-cache attention for generate()'s prefill and decode
    (``[B, S_q, H, D]`` out, q's dtype).  The kernel splits the keys at
    the serving arena's block size, ``KERNEL_TILE``, as ``paged_attention``
    does, so the two agree bit for bit in fp32.  Any ``T`` is taken; the
    ragged last tile is masked.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, ck, cv, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    name = "decode_attention"
    dtype = _check_cuda(name, q, ck, cv)
    B, Sq, H, D = q.shape
    if ck.dim() != 4 or ck.shape != cv.shape or ck.shape[0] != B \
            or ck.shape[2] != H or ck.shape[3] != D:
        raise ValueError(f"{name}: cache must be [B, T, H, D] = "
                         f"[{B}, T, {H}, {D}], got {tuple(ck.shape)}")
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"{name}: pos {pos} < 0")
    from deepspeed_tpu_torch.ops.cuda import builder
    lib = builder.load_library()
    out = torch.empty_like(q)
    rc = lib.dst_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
        B, Sq, H, D, ck.shape[1], pos, 1.0 / math.sqrt(D), dtype,
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
