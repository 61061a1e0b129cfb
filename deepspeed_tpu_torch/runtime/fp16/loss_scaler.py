"""Loss-scaler state and its update (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The scaler is a tuple of 0-dim device tensors, updated with ``torch.where``
so the overflow decision never reaches the host.  The bf16 and fp32 paths
use the static unit scaler (``unit_loss_scaler``), whose update is the
identity; dynamic fp16 scaling parses and updates here, but the engine
raises for ``"fp16": {"enabled": true}`` until the fp16 step is ported
(ROADMAP.md, Queue 1 item 5).
"""

from typing import NamedTuple, Optional

import torch


class LossScalerState(NamedTuple):
    """``scale`` is fp32; counters are int32; flags are bool."""
    scale: torch.Tensor
    good_steps: torch.Tensor
    hysteresis: torch.Tensor
    scale_window: torch.Tensor
    min_scale: torch.Tensor
    scale_factor: torch.Tensor
    delayed_shift: torch.Tensor
    dynamic: torch.Tensor
    consecutive_hysteresis: torch.Tensor


def create_loss_scaler(*, static_loss_scale: float = 0.0, initial_scale_power: int = 16,
                       loss_scale_window: int = 1000, min_loss_scale: float = 1.0,
                       hysteresis: int = 2, scale_factor: float = 2.0,
                       consecutive_hysteresis: bool = False,
                       device: Optional[torch.device] = None) -> LossScalerState:
    """``static_loss_scale > 0`` selects a fixed scale; 0 selects dynamic
    scaling starting at ``2**initial_scale_power``."""
    dynamic = static_loss_scale == 0
    scale = float(2.0 ** initial_scale_power) if dynamic else float(static_loss_scale)

    def t(value, dtype):
        return torch.tensor(value, dtype=dtype, device=device)
    return LossScalerState(
        scale=t(scale, torch.float32),
        good_steps=t(0, torch.int32),
        hysteresis=t(hysteresis, torch.int32),
        scale_window=t(loss_scale_window, torch.int32),
        min_scale=t(min_loss_scale, torch.float32),
        scale_factor=t(scale_factor, torch.float32),
        delayed_shift=t(hysteresis, torch.int32),
        dynamic=t(dynamic, torch.bool),
        consecutive_hysteresis=t(consecutive_hysteresis, torch.bool))


def unit_loss_scaler(device: Optional[torch.device] = None) -> LossScalerState:
    """Identity scaler of the bf16/fp32 paths."""
    return create_loss_scaler(static_loss_scale=1.0, device=device)


def update_scale(state: LossScalerState, overflow: torch.Tensor) -> LossScalerState:
    """Dynamic-scale transition: on overflow consume hysteresis, then halve
    (floored at ``min_scale``) and reset the window; otherwise grow by
    ``scale_factor`` every ``scale_window`` clean steps.  Static scalers
    never change."""
    s = state
    # overflow branch
    hyst_o = torch.clamp(s.hysteresis - 1, min=0)
    backoff = hyst_o <= 0
    scale_o = torch.where(backoff, torch.maximum(s.scale / s.scale_factor, s.min_scale), s.scale)
    hyst_o = torch.where(backoff, s.delayed_shift, hyst_o)
    good_o = torch.zeros_like(s.good_steps)
    # clean-step branch; a clean window (or any clean step, with
    # consecutive_hysteresis) restores the full overflow tolerance
    grown = (s.good_steps + 1) % s.scale_window == 0
    scale_c = torch.where(grown, s.scale * s.scale_factor, s.scale)
    rearm = torch.logical_or(s.consecutive_hysteresis, grown)
    hyst_c = torch.where(rearm, torch.maximum(s.delayed_shift, s.hysteresis), s.hysteresis)
    good_c = s.good_steps + 1
    new = s._replace(scale=torch.where(overflow, scale_o, scale_c),
                     good_steps=torch.where(overflow, good_o, good_c).to(torch.int32),
                     hysteresis=torch.where(overflow, hyst_o, hyst_c).to(torch.int32))
    return LossScalerState(*(torch.where(s.dynamic, a, b) for a, b in zip(new, s)))
