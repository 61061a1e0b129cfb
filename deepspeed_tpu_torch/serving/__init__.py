"""Serving subsystem: continuous batching over a paged KV-cache arena
(counterpart of ``deepspeed_tpu/serving/``).

Layering (host control plane -> device data plane):

* :mod:`deepspeed_tpu_torch.serving.kv_cache` — refcounted free-list block
  allocator + per-sequence block tables over a preallocated device arena;
* :mod:`deepspeed_tpu_torch.serving.scheduler` — admission, chunked prefill,
  SLO-class preemption;
* :mod:`deepspeed_tpu_torch.serving.prefix_cache` — refcounted trie sharing
  full prompt blocks across requests;
* :mod:`deepspeed_tpu_torch.serving.engine` — the eager decode + prefill
  step and the ``submit()/step()/run()`` surface;
* config: :class:`DeepSpeedServingConfig`, the ``"serving"`` ds_config key.
"""

from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.engine import (ServeFuture, ServingEngine,
                                                init_serving)
from deepspeed_tpu_torch.serving.kv_cache import (ArenaExhausted,
                                                  PagedKVAllocator, arena_bytes,
                                                  init_arena)
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.scheduler import (SLO_PRIORITY, QueueFull,
                                                   Request, ServingScheduler)

__all__ = [
    "ArenaExhausted",
    "DeepSpeedServingConfig",
    "PagedKVAllocator",
    "PrefixCache",
    "QueueFull",
    "Request",
    "SLO_PRIORITY",
    "ServeFuture",
    "ServingEngine",
    "ServingScheduler",
    "arena_bytes",
    "init_arena",
    "init_serving",
]
