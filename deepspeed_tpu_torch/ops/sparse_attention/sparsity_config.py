"""Block-sparsity layout configurations for sparse self-attention
(counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``,
which is numpy only; the port keeps its own copy, line for line, so every
layout equals the JAX package's bit for bit, seeds included).

Dense, Fixed (Sparse-Transformer style), Variable, BigBird, BSLongformer
and LocalSlidingWindow patterns, each producing a per-head block-level
layout ``[num_heads, num_blocks, num_blocks]`` (1 = block computed, 0 =
skipped):

- Layouts are plain ``numpy`` int32 arrays: static host metadata from
  which ``ops/cuda/block_sparse_attention.py`` builds the kernels' lookup
  tables, never a device tensor.
- ``block`` defaults to 64, the one block size the CUDA kernels are
  compiled for; the plain versions take any.
- Randomized patterns take a ``seed`` (``default_rng((seed, head))``), so
  every process builds the identical layout with no broadcast.
- Random sampling in unidirectional mode never selects future blocks.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base class: shared block/head bookkeeping for all sparsity patterns."""

    def __init__(self, num_heads: int, block: int = 64,
                 different_layout_per_head: bool = False, seed: int = 0):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1
        self.seed = seed

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=np.int32)

    def propagate_first_head(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # shared vectorized pattern pieces
    # ------------------------------------------------------------------ #
    @staticmethod
    def _block_grid(nb: int):
        r = np.arange(nb)
        return r[:, None], r[None, :]

    def _rng(self, head: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, head))


class DenseSparsityConfig(SparsityConfig):
    """All blocks active — dense attention expressed in the sparse format
    (kept for comparison, as the reference does)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern: block-diagonal local windows of
    ``num_local_blocks``, plus ``num_global_blocks`` columns per window
    (taken from the tail of each window) attended globally.  Heads may
    rotate which blocks of the window are global via
    ``num_different_global_patterns``."""

    def __init__(self, num_heads: int, block: int = 64,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1, seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"unknown attention type {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head=True")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns {num_different_global_patterns} "
                f"exceeds {num_local_blocks}//{num_global_blocks}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, nb: int) -> np.ndarray:
        R, C = self._block_grid(nb)
        same_window = (R // self.num_local_blocks) == (C // self.num_local_blocks)
        if self.attention == "unidirectional":
            return same_window & (C <= R)
        return same_window

    def _global_starts(self, h: int, nb: int) -> List[int]:
        L, G = self.num_local_blocks, self.num_global_blocks
        first = L - (1 + h % self.num_different_global_patterns) * G
        full_end = nb - nb % L
        starts = list(range(first, full_end, L))
        if full_end < nb:  # short tail window: clamp its global block in range
            starts.append(min(full_end + first, nb - G))
        return starts

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for h in range(self.num_layout_heads):
            head = self._local(nb).astype(np.int32)
            for s in self._global_starts(h, nb):
                first_row = 0 if self.attention == "bidirectional" else s
                head[first_row:, s:s + self.num_global_blocks] = 1
                if self.horizontal_global_attention:
                    head[s:s + self.num_global_blocks, :] = 1
            layout[h] = head
        return self.propagate_first_head(layout)


class VariableSparsityConfig(SparsityConfig):
    """Generalized fixed pattern: per-window sizes from
    ``local_window_blocks`` (last entry repeats), explicit global block
    indices (optionally ranges via ``global_block_end_indices``), and
    ``num_random_blocks`` random blocks per row."""

    def __init__(self, num_heads: int, block: int = 64,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False, seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"unknown attention type {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks or [4])
        self.global_block_indices = list(global_block_indices or [0])
        self.global_block_end_indices = (
            None if global_block_end_indices is None else list(global_block_end_indices))
        if self.global_block_end_indices is not None:
            if len(self.global_block_indices) != len(self.global_block_end_indices):
                raise ValueError("global start/end index lists differ in length")
            for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global block range [{s}, {e}) is empty")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def _window_bounds(self, nb: int) -> np.ndarray:
        """[nb, 2] start/end window bounds per block row."""
        bounds = np.zeros((nb, 2), dtype=np.int64)
        start = 0
        sizes = self.local_window_blocks
        i = 0
        while start < nb:
            size = sizes[min(i, len(sizes) - 1)]
            end = min(start + size, nb)
            bounds[start:end, 0] = start
            bounds[start:end, 1] = end
            start = end
            i += 1
        return bounds

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        R, C = self._block_grid(nb)
        bounds = self._window_bounds(nb)
        local = (C >= bounds[:, 0:1]) & (C < bounds[:, 1:2])
        if self.attention == "unidirectional":
            local &= C <= R
        for h in range(self.num_layout_heads):
            head = local.astype(np.int32)
            rng = self._rng(h)
            if self.num_random_blocks:
                for row in range(nb):
                    limit = nb if self.attention == "bidirectional" else row + 1
                    k = min(self.num_random_blocks, limit)
                    head[row, rng.choice(limit, size=k, replace=False)] = 1
            starts = self.global_block_indices
            ends = (self.global_block_end_indices
                    or [s + 1 for s in self.global_block_indices])
            for s, e in zip(starts, ends):
                if s >= nb:
                    continue
                e = min(e, nb)
                if self.horizontal_global_attention:
                    head[s:e, :] = 1
                first_row = 0 if self.attention == "bidirectional" else s
                head[first_row:, s:e] = 1
            if self.attention == "unidirectional":
                head = np.tril(head)
            layout[h] = head
        return self.propagate_first_head(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC pattern: sliding window + random blocks + the first
    ``num_global_blocks`` rows/columns global."""

    def __init__(self, num_heads: int, block: int = 64,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"unknown attention type {attention!r}")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        for name, n in (("random", self.num_random_blocks),
                        ("sliding window", self.num_sliding_window_blocks),
                        ("global", self.num_global_blocks)):
            if nb < n:
                raise ValueError(f"{name} blocks {n} exceed row blocks {nb}")
        R, C = self._block_grid(nb)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(R - C) <= w
        g = self.num_global_blocks
        for h in range(self.num_layout_heads):
            head = sliding.astype(np.int32)
            rng = self._rng(h)
            for row in range(nb):
                limit = nb if self.attention == "bidirectional" else row + 1
                k = min(self.num_random_blocks, limit)
                head[row, rng.choice(limit, size=k, replace=False)] = 1
            head[:g, :] = 1
            head[:, :g] = 1
            if self.attention == "unidirectional":
                head = np.tril(head)
            layout[h] = head
        return self.propagate_first_head(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + global attention at the
    given block indices (or index ranges)."""

    def __init__(self, num_heads: int, block: int = 64,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices or [0])
        self.global_block_end_indices = (
            None if global_block_end_indices is None else list(global_block_end_indices))
        if self.global_block_end_indices is not None:
            if len(self.global_block_indices) != len(self.global_block_end_indices):
                raise ValueError("global start/end index lists differ in length")
            for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global block range [{s}, {e}) is empty")
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"sliding window {self.num_sliding_window_blocks} exceeds {nb} blocks")
        R, C = self._block_grid(nb)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(R - C) <= w
        head = sliding.astype(np.int32)
        starts = self.global_block_indices
        ends = (self.global_block_end_indices
                or [s + 1 for s in self.global_block_indices])
        for s, e in zip(starts, ends):
            if s >= nb:
                continue
            e = min(e, nb)
            head[s:e, :] = 1
            head[:, s:e] = 1
        if self.attention == "unidirectional":
            head = np.tril(head)
        layout[:] = head
        return layout


MODE_TO_CONFIG = {}  # populated after all classes are defined (end of module)


def validate_sparsity_mode(mode: str) -> str:
    if mode not in MODE_TO_CONFIG:
        raise NotImplementedError(
            f"sparsity mode {mode!r} not implemented; "
            f"choose from {sorted(MODE_TO_CONFIG)}")
    return mode


def sparsity_config_from_dict(cfg: dict, num_heads: int) -> "SparsityConfig":
    """JSON ``sparse_attention`` block → SparsityConfig instance.

    Mirrors the reference's mode dispatch in ``runtime/config.py``
    (``get_sparse_attention``): ``{"mode": "bigbird", "block": 64, ...}``.
    Unknown keys raise (typo protection), unknown modes raise
    NotImplementedError like the reference.
    """
    cfg = dict(cfg)
    mode = validate_sparsity_mode(cfg.pop("mode", "fixed"))
    return MODE_TO_CONFIG[mode](num_heads=num_heads, **cfg)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Purely-local sliding window attention."""

    def __init__(self, num_heads: int, block: int = 64,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional", seed: int = 0):
        super().__init__(num_heads, block, seed=seed)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"sliding window {self.num_sliding_window_blocks} exceeds {nb} blocks")
        R, C = self._block_grid(nb)
        w = self.num_sliding_window_blocks // 2
        head = (R - C <= w) & (C - R <= (w if self.attention == "bidirectional" else 0))
        layout[:] = head.astype(np.int32)
        return layout


MODE_TO_CONFIG.update({
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "local_sliding_window": LocalSlidingWindowSparsityConfig,
})
