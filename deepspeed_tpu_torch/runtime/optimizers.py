"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

The JAX package builds an optax chain per optimizer name; the port's one
optimizer is decay-after Adam, stepped by the fused multi-tensor kernel of
``ops/cuda/fused_optim.py``: ``Adam``, ``AdamW``, ``FusedAdam`` and
``CPUAdam`` with ``adam_w_mode`` (the default).  Every other name raises,
and nothing falls back to ``torch.optim``.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.cuda.fused_optim import (AdamTable, fused_adam,
                                                      safe_int32_increment,
                                                      spec_from_config, step_scalars)

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"

ADAM_FAMILY = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM)
DS_NATIVE_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM, LAMB_OPTIMIZER,
                        FUSED_LAMB, ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                        ZERO_ONE_ADAM_OPTIMIZER, ADAGRAD_OPTIMIZER, SGD_OPTIMIZER, LION_OPTIMIZER]
UNPORTED = "ROADMAP.md, Queue 1 item 5"


class FusedAdam:
    """Decay-after Adam over a fixed list of fp32 leaves: the state optax's
    ``ScaleByAdamState`` holds (``mu``, ``nu``, ``count``), and one fused
    kernel launch per ``step``.  This object stands where the JAX package
    returns its optax transformation."""

    def __init__(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                 spec: Dict[str, Any], names: Optional[List[str]] = None):
        self.spec = spec
        self.names = list(names) if names is not None else [str(i) for i in range(len(params))]
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        self.table = AdamTable(params, grads, self.mu, self.nu)

    def step(self, inv: torch.Tensor, clip_factor: torch.Tensor) -> None:
        """Update every leaf in place from its raw gradient, which the
        kernel scales by ``inv`` (loss-scale and accumulation unscale) and
        ``clip_factor``; both are device scalars."""
        neg_lr, bc1, bc2 = step_scalars(self.spec, self.count)
        scal = torch.stack([inv, clip_factor, neg_lr, bc1, bc2]).to(torch.float32)
        fused_adam(self.table, scal, b1=self.spec["b1"], b2=self.spec["b2"],
                   eps=self.spec["eps"], wd=self.spec["wd"])
        # in place: a captured train step reads and writes this storage
        self.count.copy_(safe_int32_increment(self.count))

    def state_dict(self) -> Dict[str, Any]:
        """``{"mu": {name: tensor}, "nu": {name: tensor}, "count": tensor}``."""
        return {"mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu)),
                "count": self.count}

    def state_copies(self, sd: Dict[str, Any]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(own tensor, saved value)`` for every tensor of ``sd``, each
        name and shape checked first, so that a state that does not fit
        raises before anything is copied."""
        copies = []
        for key, dsts in (("mu", self.mu), ("nu", self.nu)):
            if set(sd[key]) != set(self.names):
                raise ValueError(f"optimizer state {key} has keys {sorted(sd[key])[:5]}..., "
                                 f"expected {self.names[:5]}...")
            for name, dst in zip(self.names, dsts):
                src = torch.as_tensor(sd[key][name])
                if dst.shape != src.shape:
                    raise ValueError(f"{key}[{name}]: shape {tuple(src.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                copies.append((dst, src))
        count = torch.as_tensor(sd["count"])
        if count.numel() != 1:
            raise ValueError(f"optimizer count: shape {tuple(count.shape)}, expected ()")
        return copies + [(self.count, count.reshape(()))]

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy the moments and the count in place (the kernel's table and
        a captured train step keep pointing at them), after checking all of
        ``sd``; ``sd`` as ``state_dict()`` returns it, or as
        ``models/convert.py:adam_state_from_jax`` does."""
        for dst, src in self.state_copies(sd):
            dst.copy_(src)


def get_optimizer(name: str, params: Dict[str, Any], leaves: List[torch.Tensor],
                  grads: List[torch.Tensor], lr_schedule: Optional[Callable] = None,
                  names: Optional[List[str]] = None) -> FusedAdam:
    """The optimizer of a ds_config ``optimizer`` block over ``leaves``
    (named ``names`` in its state dict); ``lr_schedule`` (a function of the
    device step count) overrides the static ``lr``."""
    name = name.lower()
    if name in ADAM_FAMILY:
        lr = lr_schedule if lr_schedule is not None else params.get("lr", 1e-3)
        spec = spec_from_config(name, params, lr)
        if spec is None:
            raise NotImplementedError(
                f"{name} with adam_w_mode=false and weight_decay (L2 mode) is not ported "
                f"yet ({UNPORTED})")
        return FusedAdam(leaves, grads, spec, names)
    if name in DS_NATIVE_OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet ({UNPORTED})")
    raise ValueError(f"Unknown optimizer type: {name!r} (valid: {DS_NATIVE_OPTIMIZERS})")
