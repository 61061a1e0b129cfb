"""Hang watchdog — a monotonic heartbeat with a flight-recorder trigger
(counterpart of ``deepspeed_tpu/telemetry/watchdog.py``, the same host
code).

Distributed hangs are the worst failure mode a collective-heavy runtime
has: one rank blocks in an all-reduce and every other rank blocks with
it, forever, with nothing in the logs.  The watchdog turns "forever"
into a bounded wait: the engine arms a heartbeat at step/collective
granularity (each tracer span pets it via the tracer's ``heartbeat``
hook), and if no beat lands for ``timeout_s`` the watchdog fires its
``on_stall`` callback — in production the
:class:`~deepspeed_tpu_torch.telemetry.flight_recorder.FlightRecorder` dump —
exactly once per stall.

Clock discipline: everything is ``time.monotonic_ns`` (NTP slews and
wall-clock jumps must not fake or mask a stall); this file is policed by
``tools/check_monotonic.py``.

Signal path: ``install_signal_handlers()`` chains onto SIGTERM/SIGABRT
so that a preemption or libc abort also produces a dump before the
previous handler (or the default action) runs.

Testability: the poll loop is a thin wrapper around the pure
``check(now_ns)`` method; tests drive ``check`` with a fake clock and
never need a real 120 s stall.
"""

import faulthandler  # noqa: F401  (re-exported convenience for dumps to fd)
import os
import signal
import threading
import time
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger

_mono_ns = time.monotonic_ns


class HangWatchdog:
    """Heartbeat monitor.  ``arm(what)`` starts/renames the watch,
    ``pet()`` records liveness, ``disarm()`` pauses it (e.g. between
    train_batch calls, where blocking on user code is legitimate).

    ``on_stall(watchdog, stalled_for_s, what)`` fires at most once per
    armed period; re-arming or petting after a fire re-enables it.
    """

    def __init__(self, timeout_s: float = 120.0,
                 on_stall: Optional[Callable] = None,
                 poll_s: float = 0.0,
                 clock: Optional[Callable[[], int]] = None):
        self.timeout_ns = int(float(timeout_s) * 1e9)
        self.on_stall = on_stall
        # default poll: 1/4 of the timeout, clamped to [0.5s, 10s]
        self.poll_s = float(poll_s) if poll_s and poll_s > 0 else (
            min(10.0, max(0.5, float(timeout_s) / 4.0)))
        self._clock = clock or _mono_ns
        self._lock = threading.Lock()
        self._armed = False
        self._fired = False
        self._last_beat_ns = self._clock()
        self._what = ""
        self.stall_count = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._prev_handlers = {}
        #: optional zero-arg callable -> str, logged when a stall fires —
        #: wired to CollectiveMonitor.wedged_summary so the stall log
        #: names the collective the run is stuck in
        self.context_fn: Optional[Callable[[], str]] = None

    # -- heartbeat API (hot path: one clock read under a lock) ---------- #
    def arm(self, what: str = ""):
        """Begin (or re-scope) a watched period, resetting the beat."""
        with self._lock:
            self._armed = True
            self._fired = False
            self._what = what
            self._last_beat_ns = self._clock()

    def pet(self):
        """Record liveness; wired into ``Tracer.heartbeat`` so every
        phase/collective span beats automatically."""
        with self._lock:
            self._last_beat_ns = self._clock()
            self._fired = False

    def disarm(self):
        with self._lock:
            self._armed = False

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed

    def heartbeat_age_s(self) -> float:
        """Seconds since the last beat — the ``watchdog_heartbeat_age_s``
        gauge behind ``/healthz``: readable by the obs-server scrape
        thread without perturbing the beat itself."""
        with self._lock:
            last = self._last_beat_ns
        return max(0.0, (self._clock() - last) / 1e9)

    # -- stall detection ------------------------------------------------ #
    def check(self, now_ns: Optional[int] = None) -> bool:
        """Evaluate the stall condition once; returns True iff this call
        fired ``on_stall``.  Pure given ``now_ns`` — the unit tests call
        this directly with a synthetic clock."""
        now = self._clock() if now_ns is None else int(now_ns)
        with self._lock:
            if not self._armed or self._fired:
                return False
            stalled_ns = now - self._last_beat_ns
            if stalled_ns < self.timeout_ns:
                return False
            self._fired = True
            self.stall_count += 1
            what = self._what
        stalled_s = stalled_ns / 1e9
        logger.error(
            f"watchdog: no heartbeat for {stalled_s:.1f}s "
            f"(threshold {self.timeout_ns / 1e9:.1f}s) during '{what}'")
        if self.context_fn is not None:
            try:
                logger.error(f"watchdog: {self.context_fn()}")
            except Exception:
                pass
        if self.on_stall is not None:
            try:
                self.on_stall(self, stalled_s, what)
            except Exception as e:  # a broken dump must not kill the run
                logger.error(f"watchdog: on_stall callback failed: {e}")
        return True

    # -- background poller ---------------------------------------------- #
    def start(self):
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._poll_loop, name="ds-tpu-watchdog", daemon=True)
        self._thread.start()

    def _poll_loop(self):
        while not self._stop_evt.wait(self.poll_s):
            self.check()

    def stop(self):
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.poll_s + 1.0)
        self.restore_signal_handlers()

    # -- signal chaining ------------------------------------------------- #
    def install_signal_handlers(self, signals=(signal.SIGTERM, signal.SIGABRT)):
        """Dump on termination signals, then chain to the previous
        handler (re-raising under SIG_DFL so the default action still
        happens).  Only callable from the main thread; a no-op failure
        elsewhere is logged, not raised."""
        for sig in signals:
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._handle_signal)
            except (ValueError, OSError) as e:
                logger.warning(
                    f"watchdog: cannot install handler for {sig}: {e}")

    def _handle_signal(self, signum, frame):
        logger.error(f"watchdog: received signal {signum}; dumping state")
        if self.on_stall is not None:
            try:
                self.on_stall(self, 0.0, f"signal:{signum}")
            except Exception as e:
                logger.error(f"watchdog: signal dump failed: {e}")
        prev = self._prev_handlers.get(signum, signal.SIG_DFL)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore + re-raise so the default action (terminate) runs
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        # SIG_IGN: swallow

    def restore_signal_handlers(self):
        for sig, prev in list(self._prev_handlers.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
            self._prev_handlers.pop(sig, None)
