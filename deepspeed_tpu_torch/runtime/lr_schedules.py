"""Learning-rate schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

The same families and JSON params: ``LRRangeTest``, ``OneCycle``,
``WarmupLR``, ``WarmupDecayLR``.  Each is a pure ``schedule(step) -> lr``
function of a step tensor, in fp32 torch ops with the JAX package's op
order, so it runs on the device count inside the optimizer step (the fused
Adam kernel reads ``-lr`` from the device, ``ops/cuda/fused_optim.py``),
and a stateful veneer with ``step()/get_lr()``.  Momentum cycling
(``OneCycle``'s ``cycle_momentum`` and friends) parses and does nothing,
as in the JAX package.
"""

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _step_f32(step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The step as an fp32 tensor (a device tensor stays on its device)."""
    return torch.as_tensor(step).to(torch.float32)


class _ScheduleBase:
    """Stateful veneer over a pure schedule function.  ``state_dict`` holds
    the JAX keys; its ``lr_scale`` is always 1.0: the port's stability
    ladder keeps its LR backoff on the engine (a device scale the captured
    step reads, saved as the checkpoint's ``stability.lr_backoff_scale``),
    where the JAX engine scales a schedule that has ``scale_lr``."""

    def __init__(self, schedule_fn: Callable[[torch.Tensor], torch.Tensor]):
        self._fn = schedule_fn
        self.last_batch_iteration = -1

    def schedule_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return self._fn

    def get_lr(self) -> List[float]:
        return [float(self._fn(max(self.last_batch_iteration, 0)))]

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration, "lr_scale": 1.0}

    def load_state_dict(self, sd: Dict[str, Any]):
        scale = float(sd.get("lr_scale", 1.0))
        if scale != 1.0:
            raise NotImplementedError(
                f"lr_scale {scale} in the schedule state: the port keeps the stability "
                "ladder's LR backoff on the engine, and a scale on the schedule is not "
                "read (ROADMAP.md, Queue 1 item 8)")
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_ScheduleBase):
    """Warmup then hold."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

        def fn(step):
            step = _step_f32(step)
            if self.warmup_type == WARMUP_LOG_RATE:
                gamma = self.inverse_log_warm_up * torch.log(step + 1)
            else:
                gamma = step / self.warmup_num_steps
            gamma = torch.clamp(gamma, 0.0, 1.0)
            warm = self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma
            return torch.where(step < self.warmup_num_steps, warm, self._post_warmup(step))

        super().__init__(fn)
        self.last_batch_iteration = last_batch_iteration

    def _post_warmup(self, step):
        return self.warmup_max_lr


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 over ``total_num_steps``."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _post_warmup(self, step):
        frac = (self.total_num_steps - step) / max(1, self.total_num_steps - self.warmup_num_steps)
        return self.warmup_max_lr * torch.clamp(frac, 0.0, 1.0)


class LRRangeTest(_ScheduleBase):
    """LR range test sweep."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False,
                 last_batch_iteration=-1):
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

        def fn(step):
            step = _step_f32(step)
            lr_increase = step / self.step_size
            if self.staircase:
                lr_increase = torch.floor(lr_increase)
            return self.min_lr * (1 + self.step_rate * lr_increase)

        super().__init__(fn)
        self.last_batch_iteration = last_batch_iteration


class OneCycle(_ScheduleBase):
    """1cycle policy: cycle up, cycle down, then decay."""

    def __init__(self, optimizer=None, cycle_min_lr=1e-5, cycle_max_lr=1e-3,
                 decay_lr_rate=0.0, cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.85,
                 cycle_max_mom=0.99, decay_mom_rate=0.0, last_batch_iteration=-1):
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        total_size = self.first_size + self.second_size

        def fn(step):
            step = _step_f32(step)
            scale_up = step / self.first_size
            scale_down = 1.0 - (step - self.first_size) / self.second_size
            scale = torch.where(step <= self.first_size, scale_up, scale_down)
            cyc = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * scale
            decay_steps = step - total_size
            decay_epochs = (decay_steps / self.decay_step_size if self.decay_step_size > 0
                            else decay_steps)
            dec = (self.cycle_min_lr / (1.0 + self.decay_lr_rate * decay_epochs)
                   if self.decay_lr_rate else self.cycle_min_lr)
            return torch.where(step <= total_size, cyc, dec)

        super().__init__(fn)
        self.last_batch_iteration = last_batch_iteration


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_schedule(name: str, params: Dict[str, Any]):
    """Instantiate from the ``scheduler`` JSON block."""
    if name not in VALID_LR_SCHEDULES:
        raise ValueError(f"{name} is not a valid LR schedule ({VALID_LR_SCHEDULES})")
    return SCHEDULE_CLASSES[name](**params)
