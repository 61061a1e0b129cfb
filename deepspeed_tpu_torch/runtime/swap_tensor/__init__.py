"""ZeRO-Infinity's NVMe tier (counterpart of
``deepspeed_tpu/runtime/swap_tensor/``): the ``aio`` block, an async tensor
swapper, and the parameter and optimizer-state swappers over the tiered
offload store (``runtime/offload/``)."""

from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import get_aio_config
from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    AsyncPartitionedParameterSwapper)
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper import (
    PartitionedOptimizerSwapper, PipelinedOptimizerSwapper)

__all__ = ["get_aio_config", "AsyncTensorSwapper",
           "AsyncPartitionedParameterSwapper", "PartitionedOptimizerSwapper",
           "PipelinedOptimizerSwapper"]
