"""ZeRO (counterpart of ``deepspeed_tpu/runtime/zero/``): the config, the
partition policy and layout, and the partitioned parameters."""

from deepspeed_tpu_torch.runtime.zero.partition_parameters import GatheredParameters, Init

__all__ = ["GatheredParameters", "Init"]
