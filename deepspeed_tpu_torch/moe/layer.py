"""The MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``): a gate
and a stacked expert bank behind the layer contract ``__call__(params, x,
rng=None, train=False) -> (y, l_aux, exp_counts)``, on one device.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
entry: ``ep_size > 1`` (expert parallelism over ``comm/``) and
``telemetry=`` (the expert-load gauges of the telemetry hub).
"""

from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.moe.experts import FFNExpert
from deepspeed_tpu_torch.moe.sharded_moe import (EXPERT_PARALLEL, TELEMETRY, TopKGate,
                                                 moe_dispatch_combine)


class MoE:
    """Gated mixture-of-experts layer.  The arguments are the JAX layer's:
    hidden_size, expert (default: the GELU FFN of ``expert_hidden``, or 4 x
    hidden_size; an expert here takes the stacked bank, as ``FFNExpert``
    does: ``init_params(generator, num_experts)`` and ``__call__(params
    [E, ...], x [E, C, M])``), num_experts, ep_size, k, the capacity
    factors, min_capacity, noisy_gate_policy, drop_tokens, use_rts."""

    def __init__(self, hidden_size: int, expert=None, num_experts: int = 1,
                 ep_size: int = 1, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, expert_hidden: Optional[int] = None,
                 telemetry=None):
        if ep_size > 1:
            raise NotImplementedError(f"MoE(ep_size={ep_size}) is not ported yet "
                                      f"({EXPERT_PARALLEL})")
        if telemetry is not None:
            raise NotImplementedError(f"MoE(telemetry=...) expert gauges are not ported yet "
                                      f"({TELEMETRY})")
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.experts = expert or FFNExpert(hidden_size, expert_hidden or 4 * hidden_size)
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity, noisy_gate_policy,
                             drop_tokens, use_rts)

    def init_params(self, generator: torch.Generator) -> Dict:
        return {"gate": self.gate.init_params(generator),
                "experts": self.experts.init_params(generator, self.num_experts)}

    def __call__(self, params, x: torch.Tensor, rng: Optional[torch.Generator] = None,
                 train: bool = False, noise: Optional[Dict[str, torch.Tensor]] = None):
        """x ``[..., M]`` -> (y of x's shape and dtype, l_aux, exp_counts).
        Training noise: ``noise`` (uniforms, see ``sharded_moe.py``), or
        drawn from ``rng``."""
        lead, M = x.shape[:-1], x.shape[-1]
        xt = x.reshape(-1, M)
        l_aux, routing, exp_counts = self.gate(params["gate"], xt, train=train, noise=noise,
                                               rng=rng)
        y = moe_dispatch_combine(xt, routing, self.experts, params["experts"])
        return y.reshape(*lead, M).to(x.dtype), l_aux, exp_counts
