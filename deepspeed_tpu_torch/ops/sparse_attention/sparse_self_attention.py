"""Sparse self-attention module over a block-sparsity layout (counterpart
of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

A layer that owns a master layout built from a :class:`SparsityConfig` for
``max_seq_length`` and applies block-sparse scaled-dot-product attention at
any layout-aligned sequence length, with optional relative position
embedding, key-padding mask and attention mask (each in 'add' or 'mul'
mode):

- Layouts are deterministic host metadata (seeded RNG), identical on every
  process by construction.
- The fast path is
  :func:`~deepspeed_tpu_torch.ops.cuda.block_sparse_attention.block_sparse_attention`
  (the CUDA kernels on the card, their plain versions on the CPU); calls
  carrying rpe or masks take the masked-dense path.  Both are
  differentiable.
- Tensors are ``[batch, seq, heads, head_dim]``.
"""

import logging
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    block_sparse_attention, sparse_reference_attention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig, SparsityConfig)
from deepspeed_tpu_torch.utils.logging import log_dist


class SparseSelfAttention:
    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError(f"bad key_padding_mask_mode {key_padding_mask_mode!r}")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError(f"bad attn_mask_mode {attn_mask_mode!r}")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self.master_layout = self.sparsity_config.make_layout(max_seq_length)
        self._layout_cache = {}
        self._warned_dense_fallback = False

    def get_layout(self, seq_len: int) -> np.ndarray:
        """Top-left sub-layout covering ``seq_len`` tokens."""
        block = self.sparsity_config.block
        if seq_len % block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block {block}")
        if seq_len > self.max_seq_length:
            raise ValueError(
                f"sequence length {seq_len} exceeds max_seq_length "
                f"{self.max_seq_length}")
        if seq_len not in self._layout_cache:
            nb = seq_len // block
            self._layout_cache[seq_len] = np.ascontiguousarray(
                self.master_layout[:, :nb, :nb])
        return self._layout_cache[seq_len]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        """Apply sparse attention.  Inputs are [batch, seq, heads, head_dim]."""
        if query.shape != key.shape or key.shape != value.shape:
            raise ValueError("q/k/v must share shape (self-attention)")
        S = query.shape[1]
        layout = self.get_layout(S)
        causal = getattr(self.sparsity_config, "attention", None) == "unidirectional"
        if rpe is None and key_padding_mask is None and attn_mask is None:
            return block_sparse_attention(query, key, value, layout, causal=causal)
        if not self._warned_dense_fallback:
            self._warned_dense_fallback = True
            log_dist(
                "SparseSelfAttention: rpe/key_padding_mask/attn_mask take the "
                "masked-dense path (O(S²) memory) — avoid masks at long "
                "sequence lengths or bake them into the layout",
                ranks=[0], level=logging.WARNING)
        return sparse_reference_attention(
            query, key, value, layout, causal=causal, rpe=rpe,
            key_padding_mask=key_padding_mask, attn_mask=attn_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask_mode=self.attn_mask_mode)
