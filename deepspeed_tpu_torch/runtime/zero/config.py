"""ZeRO configuration (counterpart of ``deepspeed_tpu/runtime/zero/config.py``).

The same JSON surface and pydantic model: stage 0-3, bucket sizes,
offload blocks, the ``stage3_*`` aliases and the ZeRO++ keys all parse, so
a config written for the JAX package parses here unchanged.  The engine
runs stages 0-3, offload to the CPU and ZeRO-Infinity's NVMe tier, which
reads both blocks' ``nvme_path`` and ``buffer_count``, ``offload_param``'s
``max_in_cpu`` and ``offload_optimizer``'s ``pipeline_write`` and
``max_in_cpu`` (an extra key, default 0, as the JAX engine reads it); it
raises for ZeRO++ (ROADMAP.md, Queue 1 item 7).
"""

from enum import Enum
from typing import Optional

from pydantic import Field, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_param``."""
    device: OffloadDeviceEnum = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = Field(5, ge=0)
    buffer_size: int = Field(int(1e8), ge=0)
    max_in_cpu: int = Field(int(1e9), ge=0)
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_optimizer``."""
    device: OffloadDeviceEnum = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = Field(4, ge=0)
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """``zero_optimization`` block."""

    stage: int = Field(0, ge=0, le=3)
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = Field(int(5e8), ge=0)
    allgather_partitions: bool = True
    allgather_bucket_size: int = Field(int(5e8), ge=0)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None

    sub_group_size: int = Field(int(1e9), ge=0)
    cpu_offload_param: Optional[bool] = Field(None, deprecated=True)
    cpu_offload_use_pin_memory: Optional[bool] = Field(None, deprecated=True)
    cpu_offload: Optional[bool] = Field(None, deprecated=True)
    prefetch_bucket_size: int = Field(int(5e7), ge=0, alias="stage3_prefetch_bucket_size")
    param_persistence_threshold: int = Field(int(1e5), ge=0,
                                             alias="stage3_param_persistence_threshold")
    model_persistence_threshold: int = Field(int(2**63 - 1), ge=0,
                                             alias="stage3_model_persistence_threshold")
    max_live_parameters: int = Field(int(1e9), ge=0, alias="stage3_max_live_parameters")
    max_reuse_distance: int = Field(int(1e9), ge=0, alias="stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = Field(
        False, alias="stage3_gather_16bit_weights_on_model_save")
    stage3_gather_fp16_weights_on_model_save: bool = Field(False, deprecated=True)

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = Field(1, ge=1)
    param_shard_min_size: int = Field(2**12, ge=0)
    zero_quantized_weights_bits: int = Field(8)
    zero_quantized_gradients_bits: int = Field(8)
    zero_quantization_block_size: int = Field(256, ge=2)
    prefetch_depth: int = Field(1, ge=1)
    hbm_budget_bytes: int = Field(0, ge=0)

    @model_validator(mode="after")
    def quantization_valid(self):
        for name in ("zero_quantized_weights_bits", "zero_quantized_gradients_bits"):
            bits = getattr(self, name)
            if bits not in (4, 8):
                raise ValueError(f"{name} must be 4 or 8, got {bits}")
        if self.zero_quantization_block_size % 2:
            raise ValueError("zero_quantization_block_size must be even "
                             f"(4-bit packing), got {self.zero_quantization_block_size}")
        return self

    @model_validator(mode="after")
    def overlap_comm_default(self):
        # reference default: overlap for stage 3 only.  Written through
        # __dict__ so validate_assignment does not re-run the validators.
        if self.overlap_comm is None:
            self.__dict__["overlap_comm"] = self.stage == 3
        return self

    @model_validator(mode="after")
    def offload_ratio_check(self):
        if self.__dict__.get("cpu_offload") and self.offload_optimizer is None:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
        if self.__dict__.get("cpu_offload_param") and self.offload_param is None:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
        return self
