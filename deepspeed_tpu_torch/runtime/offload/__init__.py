"""Offload tiers and planning (counterpart of
``deepspeed_tpu/runtime/offload/``).

* :mod:`.staging` — async read/write queues over CRC'd chunk files
  (background threads, bounce buffers, capped in-flight depth), the
  chunk format and manifest of the JAX package's pool;
* :mod:`.store` — keyed tensors over {host, nvme} with a bounded host
  LRU, write-through to staging and prefetch-ring hit/miss accounting;
* :mod:`.policy` — residency planner refusing, at init, a step that
  cannot fit the device-memory budget.

The serving engine's tiered KV (``serving/kv_tiering.py``) runs on the
first two, and so does ZeRO-Infinity's NVMe tier (``runtime/swap_tensor/``:
the optimizer's moments as ``runtime/zero/partition_parameters.py``'s
``NvmeFlatStore``, the parameter tier's write-through copy); ZeRO's host
tier is that module's ``FlatStore``.  ``ops/aio/`` is the native
``AIOHandle`` over ``csrc/aio/dst_aio.cpp``.
"""

from deepspeed_tpu_torch.runtime.offload.policy import (HBMBudgetError, ResidencyPlan,
                                                        check_budget, leaf_bytes,
                                                        plan_residency, tree_bytes)
from deepspeed_tpu_torch.runtime.offload.staging import (StagingError, StagingFuture,
                                                         StagingPool)
from deepspeed_tpu_torch.runtime.offload.store import (TIER_HOST, TIER_NVME, TieredStore)

__all__ = ["HBMBudgetError", "ResidencyPlan", "check_budget", "leaf_bytes",
           "plan_residency", "tree_bytes", "StagingError", "StagingFuture",
           "StagingPool", "TIER_HOST", "TIER_NVME", "TieredStore"]
