"""deepspeed_tpu_torch.testing — deterministic fault injection for driving
the fault-tolerance paths (verified checkpoints, the serving engine's
bounded dispatch and restage fallback) from plain tests (counterpart of
``deepspeed_tpu/testing/``)."""

from deepspeed_tpu_torch.testing.fault_injection import (ACTIONS, PLAN_ENV, SITES,
                                                         FaultInjected, FaultInjector,
                                                         FaultRule, FaultyCheckpointEngine,
                                                         arm_wedges, bitflip_file, clear_plan,
                                                         fault_point, get_injector,
                                                         install_plan, numeric_fault,
                                                         release_wedges, truncate_file)

__all__ = [
    "ACTIONS",
    "PLAN_ENV",
    "SITES",
    "FaultRule",
    "FaultInjector",
    "FaultInjected",
    "FaultyCheckpointEngine",
    "fault_point",
    "numeric_fault",
    "install_plan",
    "clear_plan",
    "get_injector",
    "release_wedges",
    "arm_wedges",
    "bitflip_file",
    "truncate_file",
]
