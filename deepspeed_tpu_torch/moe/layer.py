"""The MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``): a gate
and a stacked expert bank behind the layer contract ``__call__(params, x,
rng=None, train=False) -> (y, l_aux, exp_counts)``, on one device.

``telemetry=`` (a TelemetryHub) buffers a ``moe_gauge`` record of the
expert load and drop fraction (``sharded_moe.emit_expert_gauges``) at each
call, except while a CUDA stream is capturing a graph, as the JAX layer
skips them under a tracer (``deepspeed_tpu/moe/layer.py:73``).

Not ported yet, and raising ``NotImplementedError`` with its ROADMAP
entry: ``ep_size > 1`` (expert parallelism over ``comm/``).
"""

from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.moe.experts import FFNExpert
from deepspeed_tpu_torch.moe.sharded_moe import (EXPERT_PARALLEL, TopKGate,
                                                 emit_expert_gauges, moe_dispatch_combine)


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
        # optional TelemetryHub for the expert-load / drop gauges
        self.telemetry = telemetry
        self._gauge_step = 0
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
        if self.telemetry is not None and not (
                torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            self._gauge_step += 1
            emit_expert_gauges(self.telemetry, exp_counts, routing, k=self.gate.k,
                               step=self._gauge_step)
        return y.reshape(*lead, M).to(x.dtype), l_aux, exp_counts
