"""Sparse self-attention (counterpart of ``deepspeed_tpu/ops/sparse_attention/``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    VariableSparsityConfig,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    LocalSlidingWindowSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention,
)
from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    block_sparse_attention,
    sparse_reference_attention,
)

__all__ = [
    "SparsityConfig",
    "DenseSparsityConfig",
    "FixedSparsityConfig",
    "VariableSparsityConfig",
    "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig",
    "LocalSlidingWindowSparsityConfig",
    "SparseSelfAttention",
    "block_sparse_attention",
    "sparse_reference_attention",
]
