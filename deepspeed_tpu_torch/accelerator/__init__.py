"""Accelerator interface (counterpart of ``deepspeed_tpu/accelerator/``)."""

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator
from deepspeed_tpu_torch.accelerator.real_accelerator import (get_accelerator,
                                                              resolve_device,
                                                              set_accelerator)

__all__ = ["DeepSpeedAccelerator", "get_accelerator", "resolve_device",
           "set_accelerator"]
