"""Flash attention: hand-written CUDA kernels and their plain PyTorch
versions (counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``).

Layout is the framework's: q ``[B, S, H, D]``, k and v ``[B, S, Hkv, D]``
with ``H % Hkv == 0`` (query head ``h`` reads kv head ``h // (H // Hkv)``),
o ``[B, S, H, D]``; the row statistics lse and delta are fp32 ``[B, H, S]``
(the JAX kernels' ``[B, H, S, 1]`` is a Mosaic tiling artefact).  ``bias``
is a dense fp32 logit bias ``[Bb, Hb, S, S]`` (``Bb`` in {1, B}, ``Hb`` in
{1, H}); ``slopes`` are the ``[H]`` fp32 ALiBi slopes, added as
``slope * (key - query)``.  Both are constants under differentiation.

Three entry points, one per TPU kernel, each with its plain version:

* ``flash_forward`` -> (o, lse); replaces ``_fwd_kernel``
  (``ops/pallas/flash_attention.py:154``);
* ``flash_backward_dq`` -> dq; replaces ``_bwd_dq_kernel`` (``:249``);
* ``flash_backward_dkv`` -> (dk, dv); replaces ``_bwd_dkv_kernel``
  (``:293``).

The plain versions (``*_reference``) form full ``S x S`` score matrices
with the JAX kernels' roundings: every product takes its operands in
their dtype and sums in fp32 (JAX's ``preferred_element_type=float32``;
written as a product of the operands upcast to fp32, which is exact for
bf16 operands, as on the tensor cores), the scale applies to the fp32
scores after the product, p is rounded to v's dtype before ``p . v`` (and
to do's before ``p^T . do``), ds to the input dtype before ``ds . k`` and
``ds^T . q``, and the outputs to the input dtypes.  So a bf16 kernel is
held against exact products with no option: rounding a bf16 product's
output, as a bf16 ``einsum`` does, moves dq by a tenth of its largest
value in bf16 (``dp - delta`` cancels), far from what the JAX kernels do.

Masking: causally masked columns are ``-inf`` and the running max starts
at JAX's ``NEG_INF = -1e30``.  On every row that keeps a column this is
JAX's result; a row whose every column a bias sets to ``-1e30`` averages
uniformly over its unmasked columns (over all of them without the causal
mask, as in JAX), in the kernels and the plain versions alike.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel of ``csrc/flash_attention.cu`` or raises on a dtype, head_dim,
shape, layout or device the kernel does not take.  There is no fallback.
All three kernels are compiled for head_dim 64 (GPT-2), 96 (GPT-NeoX-20B),
128 (LLaMA, BLOOM) and 256 (GPT-J), ``KERNEL_HEAD_DIMS`` (dQ and dKV:
``BACKWARD_HEAD_DIMS``, the same); another width raises on the card naming
its ROADMAP entry.
The kernels read q, k, v and do by strides (head_dim contiguous, rows on
16-byte boundaries), so the model's ``[B, S, H, D]`` views of its qkv
product go in without copies; o, dq, dk and dv come out contiguous.
Kernel notes (bound, design) are in the ``.cu`` file.

``flash_attention`` is differentiable in q, k and v through the custom op
``dst_torch::flash_fwd`` (returning o and lse) and its registered
backward, so selective activation checkpointing can save the op's outputs
(``runtime/activation_checkpointing/checkpointing.py``).

Each wrapper counts its launches (``flash_forward.launches``); each plain
version counts its calls (``flash_forward_reference.calls``).
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.attention import canonical_bias, expand_kv_heads
from deepspeed_tpu_torch.ops.cuda import builder

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 96, 128, 256)   # the head_dims the forward is compiled for
BACKWARD_HEAD_DIMS = (64, 96, 128, 256)  # ... and dQ and dKV
OTHER_HEAD_DIMS = "ROADMAP.md, Queue 2 part A: flash kernels at other head_dims"
FP16 = "ROADMAP.md, Queue 1 item 5 (fp16 training)"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def _product(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` summed in fp32 from the operands' values."""
    return torch.einsum(eq, a.float(), b.float())


def _scores(q, k, bias, slopes, causal: bool, scale: float):
    """``[B, H, S, S]`` fp32 scores (k expanded to q's heads): ``q . k^T``
    scaled after the product, plus the bias and ALiBi, ``-inf`` past the
    diagonal when causal."""
    S = q.shape[1]
    s = _product(q, k, "bqhd,bkhd->bhqk") * scale
    if bias is not None:
        s = s + bias.float()
    if slopes is not None or causal:
        pos = torch.arange(S, device=q.device)
        dist = (pos[None, :] - pos[:, None]).float()          # key - query
    if slopes is not None:
        s = s + slopes.float()[None, :, None, None] * dist
    if causal:
        s = torch.where(dist <= 0, s, -math.inf)
    return s


def flash_forward_reference(q, k, v, bias, slopes, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype ``[B, S, H, D]``, lse fp32 ``[B, H, S]``)."""
    flash_forward_reference.calls += 1
    k, v = expand_kv_heads(q, k, v)
    s = _scores(q, k, bias, slopes, causal, scale)
    m = s.amax(-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = _product(p.to(v.dtype), v, "bhqk,bkhd->bhqd")
    o = torch.where(l > 0, pv / l, 0.0)
    return o.transpose(1, 2).to(q.dtype).contiguous(), (m + torch.log(l))[..., 0]


flash_forward_reference.calls = 0


def _ds(q, k, v, do, lse, delta, bias, slopes, causal, scale):
    """(p, ds rounded to q's dtype), both ``[B, H, S, S]`` (k and v
    expanded to q's heads)."""
    p = torch.exp(_scores(q, k, bias, slopes, causal, scale) - lse[..., None])
    dp = _product(do, v, "bqhd,bkhd->bhqk")
    return p, (p * (dp - delta[..., None]) * scale).to(q.dtype)


def flash_backward_dq_reference(q, k, v, do, lse, delta, bias, slopes, causal: bool,
                                scale: float) -> torch.Tensor:
    """dq ``[B, S, H, D]`` in q's dtype, against the given lse and delta
    (``rowsum(do * o)``), fp32 ``[B, H, S]``."""
    flash_backward_dq_reference.calls += 1
    k, v = expand_kv_heads(q, k, v)
    _, ds = _ds(q, k, v, do, lse, delta, bias, slopes, causal, scale)
    return _product(ds, k, "bhqk,bkhd->bqhd").to(q.dtype)


flash_backward_dq_reference.calls = 0


def flash_backward_dkv_reference(q, k, v, do, lse, delta, bias, slopes, causal: bool,
                                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``[B, S, Hkv, D]`` in k's and v's dtypes, each summed in
    fp32 over the query heads of its group."""
    flash_backward_dkv_reference.calls += 1
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    p, ds = _ds(q, *expand_kv_heads(q, k, v), do, lse, delta, bias, slopes, causal, scale)
    dv = _product(p.to(do.dtype), do, "bhqk,bqhd->bkhd")
    dk = _product(ds, q, "bhqk,bqhd->bkhd")

    def group_sum(t):
        return t.reshape(B, S, Hkv, H // Hkv, D).sum(3)
    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


flash_backward_dkv_reference.calls = 0


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def check_head_dim(name: str, D: int, backward: bool) -> None:
    dims = BACKWARD_HEAD_DIMS if backward else KERNEL_HEAD_DIMS
    if D not in dims:
        raise NotImplementedError(f"{name}: the CUDA kernels are compiled for head_dim "
                                  f"{', '.join(map(str, dims))}, got {D} ({OTHER_HEAD_DIMS})")


def _check(name: str, q, k, v, do=None, lse=None, delta=None, bias=None, slopes=None) -> int:
    """Validate what the kernels take (the backward's when ``do`` is
    given); returns the dtype code."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{name}: q must be [B, S, H, D] and k, v [B, S, Hkv, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"{name}: k and v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"{name}: {H} q heads not a multiple of {Hkv} kv heads")
    check_head_dim(name, D, do is not None)
    if B == 0 or S == 0 or B > 65535 or H > 65535 or B * S * H * D >= 2 ** 31:
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
    if bias is not None and (bias.dtype != torch.float32 or bias.dim() != 4
                             or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H)
                             or tuple(bias.shape[2:]) != (S, S)):
        raise TypeError(f"{name}: bias must be fp32 [1|{B}, 1|{H}, {S}, {S}], got "
                        f"{bias.dtype} {tuple(bias.shape)}")
    if slopes is not None and (slopes.dtype != torch.float32 or tuple(slopes.shape) != (H,)
                               or not slopes.is_contiguous()):
        raise TypeError(f"{name}: ALiBi slopes must be contiguous fp32 [{H}]")
    tensors = [t for t in (q, k, v, do, lse, delta, bias, slopes) if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"{name}: no kernel for devices {devices}")
    vec = 16 // q.element_size()
    for t in inputs:
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: CUDA kernels take head_dim contiguous and rows, heads "
                             f"and batches on 16-byte boundaries; got strides {t.stride()}")
    return _DTYPE_CODES[q.dtype]


def _strides(q, k, v, do, bias):
    """The kernels' stride table: (b, s, h) of q, k, v and do, then (b, h,
    q, k) of the bias, 0 where it broadcasts."""
    vals = [st for t in (q, k, v) for st in t.stride()[:3]]
    vals += list(do.stride()[:3]) if do is not None else [0, 0, 0]
    if bias is not None:
        vals += [bias.stride(0) if bias.shape[0] > 1 else 0,
                 bias.stride(1) if bias.shape[1] > 1 else 0, bias.stride(2), bias.stride(3)]
    else:
        vals += [0, 0, 0, 0]
    return (ctypes.c_longlong * 16)(*vals)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_forward(q, k, v, bias, slopes, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o ``[B, S, H, D]`` in q's dtype, lse fp32 ``[B, H, S]``).  CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, bias, slopes, causal, scale)
    dtype = _check("flash_forward", q, k, v, bias=bias, slopes=slopes)
    B, S, H, D = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = builder.load_library()
    rc = lib.dst_flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                               _ptr(slopes), o.data_ptr(), lse.data_ptr(),
                               _strides(q, k, v, None, bias), B, S, H, k.shape[2], D,
                               scale, int(causal), dtype,
                               torch.cuda.current_stream(q.device).cuda_stream)
    builder.check(lib, rc, "flash_forward")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_backward_dq(q, k, v, do, lse, delta, bias, slopes, causal: bool,
                      scale: float) -> torch.Tensor:
    """dq ``[B, S, H, D]`` in q's dtype.  CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, do, lse, delta, bias, slopes, causal, scale)
    dtype = _check("flash_backward_dq", q, k, v, do, lse, delta, bias, slopes)
    B, S, H, D = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = builder.load_library()
    rc = lib.dst_flash_backward_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), _ptr(bias), _ptr(slopes),
                                   dq.data_ptr(), _strides(q, k, v, do, bias), B, S, H,
                                   k.shape[2], D, scale, int(causal), dtype,
                                   torch.cuda.current_stream(q.device).cuda_stream)
    builder.check(lib, rc, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward_dkv(q, k, v, do, lse, delta, bias, slopes, causal: bool,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``[B, S, Hkv, D]`` in k's and v's dtypes, summed over each
    kv head's query group inside one block (no atomics: deterministic).
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, do, lse, delta, bias, slopes, causal,
                                            scale)
    dtype = _check("flash_backward_dkv", q, k, v, do, lse, delta, bias, slopes)
    B, S, H, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = builder.load_library()
    rc = lib.dst_flash_backward_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                    lse.data_ptr(), delta.data_ptr(), _ptr(bias), _ptr(slopes),
                                    dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, bias),
                                    B, S, H, k.shape[2], D, scale, int(causal), dtype,
                                    torch.cuda.current_stream(q.device).cuda_stream)
    builder.check(lib, rc, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


_KERNEL_CODES = {"forward": 0, "dq": 1, "dkv": 2}


def kernel_occupancy(kernel: str, dtype: torch.dtype, extras: bool = False,
                     head_dim: int = 64) -> Tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of one flash
    kernel on the current card, by CUDA's occupancy query: ``kernel`` is
    "forward", "dq" or "dkv", ``extras`` its bias / ALiBi instantiation,
    ``head_dim`` one it is compiled for.  Launches nothing."""
    dims = KERNEL_HEAD_DIMS if kernel == "forward" else BACKWARD_HEAD_DIMS
    if kernel not in _KERNEL_CODES or dtype not in _DTYPE_CODES or head_dim not in dims:
        raise ValueError(f"kernel_occupancy: no kernel {kernel!r} for {dtype} at "
                         f"head_dim {head_dim}")
    lib = builder.load_library()
    smem = ctypes.c_int(0)
    blocks = lib.dst_flash_occupancy(_KERNEL_CODES[kernel], _DTYPE_CODES[dtype], head_dim,
                                     int(extras), ctypes.byref(smem))
    if blocks <= 0:
        raise RuntimeError(f"kernel_occupancy: the occupancy query failed for {kernel}")
    return blocks, smem.value


# the ring-attention hop bodies of the JAX package, against an external lse
flash_block_fwd = flash_forward


def flash_block_bwd(q, k, v, do, lse, delta, bias=None, slopes=None, *, causal: bool,
                    scale: float):
    """(dq, dk, dv) against an external lse and ``delta = rowsum(do * o)``,
    both fp32 ``[B, H, S]``."""
    dq = flash_backward_dq(q, k, v, do, lse, delta, bias, slopes, causal, scale)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, bias, slopes, causal, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# The differentiable op
# --------------------------------------------------------------------------- #
@torch.library.custom_op("dst_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
                 slopes: Optional[torch.Tensor], causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of ``flash_forward``, as one dispatcher op (the outputs JAX
    names ``flash_o`` and ``flash_lse``)."""
    return flash_forward(q, k, v, bias, slopes, causal, scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, bias, slopes, causal, scale):
    B, S, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, S), dtype=torch.float32)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, bias, slopes, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, bias, slopes, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, bias, slopes, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()      # [B, H, S]
    dq, dk, dv = flash_block_bwd(q, k, v, do, lse, delta, bias, slopes, causal=ctx.causal,
                                 scale=ctx.scale)
    # bias and slopes are constants under differentiation
    return dq, dk, dv, None, None, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    bias=None, alibi=None) -> torch.Tensor:
    """``[B, S, H, D]`` flash attention, differentiable in q, k and v.
    ``bias`` is broadcastable to ``[B, H, S, S]`` (rank 2 and 3
    right-aligned), ``alibi`` the ``[H]`` slopes; both are constants under
    differentiation."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attention: {H} q heads not a multiple of {Hkv} kv heads")
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        check_head_dim("flash_attention", D, backward=True)   # before a forward it could not undo
    bias = canonical_bias(bias)
    if bias is not None:
        bias = bias.detach().float().broadcast_to((bias.shape[0], bias.shape[1], S, S))
    slopes = None
    if alibi is not None:
        slopes = torch.as_tensor(alibi).detach().to(q.device, torch.float32).reshape(H)
    o, _ = flash_fwd_op(q, k, v, bias, slopes, causal, 1.0 / math.sqrt(D))
    return o


def reset_counts() -> None:
    """Zero every launch and plain-call counter of this module."""
    for fn in (flash_forward, flash_backward_dq, flash_backward_dkv):
        fn.launches = 0
    for fn in (flash_forward_reference, flash_backward_dq_reference,
               flash_backward_dkv_reference):
        fn.calls = 0
