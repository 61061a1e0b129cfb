"""Attention for the training forward (counterpart of
``deepspeed_tpu/ops/attention.py``).

Every implementation has the JAX package's signature and layout::

    fn(q, k, v, *, causal: bool, bias=None, alibi=None) -> out
    # [batch, seq, heads, head_dim]; k/v may carry fewer heads (GQA)

``bias`` is broadcastable to ``[B, H, S, Sk]`` (rank 2 and 3 right-aligned
by ``canonical_bias``), ``alibi`` the per-head slopes ``[H]``; both are
constants under differentiation on every path.

* ``reference_attention``: plain torch ops in the JAX op order (fp32
  logits, ``-1e30`` causal mask, probabilities cast to q's dtype).  It is
  what JAX runs outside any Pallas kernel, so it is not written as
  ``scaled_dot_product_attention``.
* ``flash_attention``: ``ops/cuda/flash_attention.py``, on both devices:
  the hand-written forward, dQ and dKV kernels on the card, their plain
  versions on the CPU.
* ``auto_attention``: the reference up to ``XLA_FUSED_MAX_SEQ`` tokens
  (the JAX package's switch point, kept as it is), flash above.

``register_attention(name, fn)`` adds an implementation of that signature
under a name, which ``GPTConfig.attn_impl`` can then select (a block-sparse
``SparseSelfAttention`` behind an adapter, for instance), as in the JAX
package.
"""

import math
from typing import Callable

import numpy as np
import torch

SEQUENCE_PARALLEL = "ROADMAP.md, Queue 1 item 9 (sequence parallel attention)"

# the JAX package's switch point between dense and flash attention
XLA_FUSED_MAX_SEQ = 256


def expand_kv_heads(q, k, v):
    """Repeat grouped K/V heads up to q's head count."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv == H:
        return k, v
    if H % Hkv:
        raise ValueError(f"{H} q heads not a multiple of {Hkv} kv heads")
    return k.repeat_interleave(H // Hkv, dim=2), v.repeat_interleave(H // Hkv, dim=2)


def canonical_bias(bias):
    """Right-align a logit bias to rank 4 (``[B|1, H|1, q, k]``); the
    contract admits rank 2 and 3."""
    if bias is None:
        return None
    if bias.dim() > 4:
        raise ValueError(f"bias rank {bias.dim()} > 4")
    while bias.dim() < 4:
        bias = bias[None]
    return bias


def reference_attention(q, k, v, *, causal: bool = True, bias=None, alibi=None):
    """Multi-head attention with fp32 softmax.  ``bias`` (broadcastable to
    ``[B, H, S, Sk]``) and ``alibi`` (per-head slopes) are constants under
    differentiation, as on every JAX path."""
    k, v = expand_kv_heads(q, k, v)
    S, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(D))
    if bias is not None:
        logits = logits + bias.detach().float()
    if alibi is not None:
        slopes = torch.as_tensor(alibi).detach().to(q.device, torch.float32)
        dist = (torch.arange(Sk, device=q.device)[None, :]
                - torch.arange(S, device=q.device)[:, None]).float()
        logits = logits + slopes[None, :, None, None] * dist[None, None]
    if causal:
        mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, *, causal: bool = True, bias=None, alibi=None):
    """Flash attention: the CUDA kernels on the card, their plain versions
    on the CPU (``ops/cuda/flash_attention.py``)."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention as fa
    return fa(q, k, v, causal=causal, bias=bias, alibi=alibi)


def auto_attention(q, k, v, *, causal: bool = True, bias=None, alibi=None):
    """Dense reference up to ``XLA_FUSED_MAX_SEQ`` tokens, flash above."""
    if q.shape[1] <= XLA_FUSED_MAX_SEQ:
        return reference_attention(q, k, v, causal=causal, bias=bias, alibi=alibi)
    return flash_attention(q, k, v, causal=causal, bias=bias, alibi=alibi)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (BLOOM; the paper's geometric sequence)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if np.log2(num_heads).is_integer():
        return np.asarray(pow2_slopes(num_heads), np.float32)
    closest = 2 ** int(np.floor(np.log2(num_heads)))
    extra = pow2_slopes(2 * closest)[0::2][:num_heads - closest]
    return np.asarray(pow2_slopes(closest) + extra, np.float32)


def alibi_bias(num_heads: int, q_len: int, k_len: int, q_offset: int = 0,
               device=None) -> torch.Tensor:
    """``[1, H, q, k]`` additive ALiBi bias: ``slope_h * (k_pos - q_pos)``."""
    slopes = torch.from_numpy(alibi_slopes(num_heads)).to(device)
    qpos = q_offset + torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(k_len, device=device)[None, :]
    dist = (kpos - qpos).float()                  # <= 0 in the causal past
    return (slopes[:, None, None] * dist)[None]


_REGISTRY = {
    "auto": auto_attention,
    "reference": reference_attention,
    "flash": flash_attention,
}


def get_attention_fn(impl: str = "auto") -> Callable:
    """Resolve an attention implementation by name."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(f"attn_impl={impl!r} is not ported yet ({SEQUENCE_PARALLEL})")
    if impl not in _REGISTRY:
        raise ValueError(f"unknown attention impl {impl!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[impl]


def register_attention(name: str, fn: Callable) -> None:
    """Make ``fn`` the attention that ``get_attention_fn(name)`` returns."""
    _REGISTRY[name] = fn
