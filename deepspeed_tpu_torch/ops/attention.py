"""Attention for the training forward (counterpart of
``deepspeed_tpu/ops/attention.py``).

Every implementation has the JAX package's signature and layout::

    fn(q, k, v, *, causal: bool, bias=None, alibi=None) -> out
    # [batch, seq, heads, head_dim]; k/v may carry fewer heads (GQA)

* ``reference_attention``: plain torch ops in the JAX op order (fp32
  logits, ``-1e30`` causal mask, probabilities cast to q's dtype).  It is
  what JAX runs outside any Pallas kernel, so it is not written as
  ``scaled_dot_product_attention``.
* ``flash_attention``: the Pallas kernel's port is not written yet
  (ROADMAP.md, Queue 2 rows 1-3).  On CUDA it raises; on the CPU it runs
  the reference, as the JAX package does off the TPU.
* ``auto_attention``: the reference up to ``XLA_FUSED_MAX_SEQ`` tokens,
  flash above.
"""

import math
from typing import Callable

import torch

FLASH = "ROADMAP.md, Queue 2 rows 1-3 (flash attention)"
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
        slopes = alibi.detach().float()
        dist = (torch.arange(Sk, device=q.device)[None, :]
                - torch.arange(S, device=q.device)[:, None]).float()
        logits = logits + slopes[None, :, None, None] * dist[None, None]
    if causal:
        mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, *, causal: bool = True, bias=None, alibi=None):
    """Flash attention: not ported to CUDA yet; the reference on the CPU."""
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"flash_attention has no CUDA kernel yet ({FLASH}); sequences up to "
            f"{XLA_FUSED_MAX_SEQ} tokens take the reference path under attn_impl='auto'")
    return reference_attention(q, k, v, causal=causal, bias=bias, alibi=alibi)


def auto_attention(q, k, v, *, causal: bool = True, bias=None, alibi=None):
    """Dense reference up to ``XLA_FUSED_MAX_SEQ`` tokens, flash above."""
    if q.shape[1] <= XLA_FUSED_MAX_SEQ:
        return reference_attention(q, k, v, causal=causal, bias=bias, alibi=alibi)
    return flash_attention(q, k, v, causal=causal, bias=bias, alibi=alibi)


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
