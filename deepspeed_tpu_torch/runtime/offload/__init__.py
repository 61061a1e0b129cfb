"""Offload planning (counterpart of ``deepspeed_tpu/runtime/offload/``).

The host tier itself is ``runtime/zero/partition_parameters.py``'s
``FlatStore``; this package holds the residency planner that refuses, at
init, a step that cannot fit the device-memory budget.  The NVMe tier
(``staging``, ``store``) is not ported (ROADMAP.md, Queue 1 item 7).
"""

from deepspeed_tpu_torch.runtime.offload.policy import (HBMBudgetError, ResidencyPlan,
                                                        check_budget, leaf_bytes,
                                                        plan_residency, tree_bytes)

__all__ = ["HBMBudgetError", "ResidencyPlan", "check_budget", "leaf_bytes",
           "plan_residency", "tree_bytes"]
