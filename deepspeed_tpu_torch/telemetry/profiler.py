"""Windowed ``torch.profiler`` capture (counterpart of
``deepspeed_tpu/telemetry/profiler.py``, which captures an XLA trace).

Config-driven start / stop of a ``torch.profiler.profile`` with the CPU and
CUDA activities over a single ``[start_step, end_step)`` window; at the
stop the trace is written into ``log_dir`` as Chrome-trace JSON
(``trace_rank<R>_<pid>.json``, what ``profile.export_chrome_trace``
writes).  The state machine has exactly three
states — idle → active → done — and two invariants the tests pin down:

* a trace **never starts twice** (once done, the window stays done even if
  the step counter wraps or re-enters the window);
* a trace **always stops** — via ``step_end`` once the window closes, or
  via ``close()`` on engine teardown, whichever comes first.  The window
  length is clamped to ``max_window_steps`` so a mis-configured
  ``end_step`` can never leave tracing running unbounded.

``start_fn``/``stop_fn`` are injectable for tests; the defaults wrap
``torch.profiler`` and swallow its errors (profiling is best-effort
observability, never a reason to kill a training run).  A step replayed
from a captured CUDA graph shows in the trace as the graph launch and the
kernels it ran, as far as the profiler sees into a graph.
"""

import os
import tempfile
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger

IDLE = "idle"
ACTIVE = "active"
DONE = "done"

#: hard ceiling on a capture window — profiler traces are large, and an
#: unbounded trace can fill a host disk in minutes.
MAX_WINDOW_STEPS = 64

#: the ``profiler_dir`` default: under the temporary directory (``TMPDIR``)
DEFAULT_PROFILER_DIR = os.path.join(tempfile.gettempdir(), "deepspeed_tpu_trace")


class _TorchTrace:
    """One ``torch.profiler.profile`` session writing its Chrome trace
    into ``log_dir`` when it stops; ``path`` is the file written."""

    def __init__(self):
        self._prof = None
        self._dir = None
        self.path = None

    def start(self, log_dir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
        self._prof, self._dir = prof, log_dir

    def stop(self):
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        from deepspeed_tpu_torch import comm
        path = os.path.join(self._dir, f"trace_rank{comm.get_rank()}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.path = path


class ProfilerWindow:
    """One-shot profiler capture over ``[start_step, end_step)``."""

    def __init__(self, start_step: int, end_step: int, log_dir: str,
                 max_window_steps: int = MAX_WINDOW_STEPS,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None):
        self.start_step = int(start_step)
        clamp = self.start_step + max(1, int(max_window_steps))
        self.end_step = min(int(end_step), clamp)
        if int(end_step) > clamp:
            logger.warning(
                f"profiler window [{start_step}, {end_step}) clamped to "
                f"[{self.start_step}, {self.end_step}) "
                f"(max_window_steps={max_window_steps})")
        self.log_dir = log_dir
        self.state = IDLE
        self._trace = _TorchTrace()
        self._start_fn = start_fn or self._trace.start
        self._stop_fn = stop_fn or self._trace.stop

    @property
    def trace_path(self) -> Optional[str]:
        """The Chrome-trace file the default capture wrote (None before
        its stop, or with an injected ``stop_fn``)."""
        return self._trace.path

    @property
    def active(self) -> bool:
        return self.state == ACTIVE

    def step_begin(self, step: int):
        """Call with the about-to-run step index (pre-increment counter)."""
        if self.state != IDLE:
            return
        if self.start_step <= step < self.end_step:
            try:
                self._start_fn(self.log_dir)
            except Exception as e:
                logger.warning(f"profiler start_trace failed: {e}")
                self.state = DONE
                return
            self.state = ACTIVE
            logger.info(f"profiler trace started at step {step} "
                        f"(window [{self.start_step}, {self.end_step}) "
                        f"-> {self.log_dir})")

    def step_end(self, completed_steps: int):
        """Call with the number of completed steps (post-increment counter)."""
        if self.state == ACTIVE and completed_steps >= self.end_step:
            self._stop()

    def _stop(self):
        try:
            self._stop_fn()
        except Exception as e:
            logger.warning(f"profiler stop_trace failed: {e}")
        finally:
            self.state = DONE
            logger.info(f"profiler trace stopped -> {self.log_dir}")

    def close(self):
        """Teardown hook: stop an in-flight trace no matter where the step
        counter is.  Idempotent."""
        if self.state == ACTIVE:
            self._stop()

    @classmethod
    def from_config(cls, tcfg) -> Optional["ProfilerWindow"]:
        """Build from a ``DeepSpeedTelemetryConfig``; None when disabled."""
        if not tcfg.profiler_start_step and not tcfg.profiler_end_step:
            return None
        start = tcfg.profiler_start_step or 0
        end = tcfg.profiler_end_step or (start + 1)
        if end <= start:
            logger.warning(
                f"profiler window [{start}, {end}) is empty; disabled")
            return None
        return cls(start, end, tcfg.profiler_dir,
                   max_window_steps=tcfg.profiler_max_window_steps)
