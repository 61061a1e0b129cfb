"""Throughput timer (counterpart of ``ThroughputTimer`` in
``deepspeed_tpu/utils/timer.py``).

The same design point as the JAX package's: never synchronize inside a
step.  Steps are only counted; the device is drained (the accelerator's
``synchronize``) at the start of a measurement window, once
``global_step_count`` reaches ``start_step``, and every
``steps_per_output`` steps, and throughput is window samples over window
time.  ``start_step`` set past the run's length (``bench.py:137`` sets
``10**12``) keeps every drain out of a timed loop.
"""

import time
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import log_dist


class ThroughputTimer:
    """Samples/s over measured windows; ``batch_size`` is the global train
    batch per step and ``synchronize`` drains the device."""

    def __init__(self, batch_size, synchronize: Callable[[], None], start_step=2,
                 steps_per_output=50, logging_fn: Optional[Callable] = None):
        self.batch_size = max(1, batch_size)
        self.synchronize = synchronize
        self.start_step = start_step
        self.steps_per_output = max(1, steps_per_output)
        self.logging = logging_fn or log_dist
        self.started = False
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self._window_start = 0.0
        self._window_step0 = 0
        self._last_stop = 0.0
        self._excluded = 0.0   # host time between stop() and the next start()
        self.total_elapsed_time = 0.0
        self._measured_steps = 0

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.started = True
        if self._window_start == 0.0 and self.global_step_count >= self.start_step:
            self.synchronize()
            self._window_start = time.time()
            self._window_step0 = self.global_step_count
            self._excluded = 0.0
        elif self._last_stop > 0.0:
            # host time outside train steps is not training throughput
            self._excluded += time.time() - self._last_stop
            self._last_stop = 0.0

    def _close_window(self, report_speed):
        self.synchronize()
        now = time.time()
        window = self.global_step_count - self._window_step0
        duration = max(now - self._window_start - self._excluded, 1e-9)
        self.total_elapsed_time += duration
        self._measured_steps += window
        if report_speed and window > 0:
            self.logging(
                f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                f"global_step={self.global_step_count}, RunningAvgSamplesPerSec="
                f"{self.avg_samples_per_sec():.3f}, CurrSamplesPerSec="
                f"{self.batch_size * window / duration:.3f}")
        self._window_start = now
        self._window_step0 = self.global_step_count
        self._excluded = 0.0
        self._last_stop = 0.0

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if not global_step:
            return
        self.global_step_count += 1
        self._last_stop = time.time()
        if (self._window_start > 0.0
                and self.global_step_count - self._window_step0 >= self.steps_per_output):
            self._close_window(report_speed)

    def avg_samples_per_sec(self):
        if (self._measured_steps == 0 and self._window_start > 0.0
                and self.global_step_count > self._window_step0):
            # a run shorter than one window: close it now
            self._close_window(report_speed=False)
        if self._measured_steps > 0 and self.total_elapsed_time > 0:
            return self.batch_size * self._measured_steps / self.total_elapsed_time
        return 0.0
