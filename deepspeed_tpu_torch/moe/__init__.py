from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import TopKGate, top1gating, top2gating

__all__ = ["MoE", "TopKGate", "top1gating", "top2gating"]
