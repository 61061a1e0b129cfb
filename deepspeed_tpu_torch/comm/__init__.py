"""Collectives over ``torch.distributed`` and bounded execution
(counterpart of ``deepspeed_tpu/comm/``)."""

from deepspeed_tpu_torch.comm.bounded import BoundedCollective, CollectiveTimeout
from deepspeed_tpu_torch.comm.comm import (ReduceOp, all_gather, all_reduce, barrier,
                                           broadcast, broadcast_object_list,
                                           configure_collective_monitor,
                                           configure_metrics_registry,
                                           destroy_process_group, env_world_size,
                                           get_local_rank, get_rank, get_world_size,
                                           init_distributed, is_initialized, reduce_scatter)

__all__ = ["BoundedCollective", "CollectiveTimeout", "ReduceOp", "all_gather", "all_reduce",
           "barrier", "broadcast", "broadcast_object_list", "configure_collective_monitor",
           "configure_metrics_registry", "destroy_process_group",
           "env_world_size", "get_local_rank", "get_rank", "get_world_size",
           "init_distributed", "is_initialized", "reduce_scatter"]
