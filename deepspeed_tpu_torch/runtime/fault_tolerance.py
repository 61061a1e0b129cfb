"""Fault-tolerance primitives: transient-error retry, restart backoff and
preemption-aware shutdown (counterpart of
``deepspeed_tpu/runtime/fault_tolerance.py``).  The checkpoint layer
(``runtime/checkpointing.py``), the engine and the elastic agent
(``elasticity/elastic_agent.py``) share them:

* :func:`retry_transient` / :func:`backoff_delay` — capped exponential
  backoff with jitter, injectable clock and rng so tests never sleep;
* :class:`PreemptionHandler` — SIGTERM (plus a pluggable cloud-metadata
  probe) turned into a cooperative flag that the engine checks at the
  step boundary, after the replay, and answers with a final synchronous
  checkpoint and a clean exit carrying :data:`PREEMPTION_EXIT_CODE`;
* the checkpoint errors (:class:`CheckpointWriteError`,
  :class:`CheckpointCorruptError`).

Standard library only.
"""

import importlib
import random
import signal
import threading
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger

# A preempted worker exits with 128 + SIGTERM, the code an unhandled SIGTERM
# gives, so the elastic agent tells "the scheduler took the machine"
# (restart now, keep the restart budget) from "the program crashed"
# (back off) without a side channel.
PREEMPTION_EXIT_CODE = 128 + signal.SIGTERM       # 143
PREEMPTION_EXIT_CODES = (PREEMPTION_EXIT_CODE, -signal.SIGTERM)


class CheckpointError(Exception):
    """Base of the checkpoint fault taxonomy."""


class CheckpointWriteError(CheckpointError):
    """A save (or its async finalize) failed after exhausting retries."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint failed manifest verification at load."""


def backoff_delay(attempt: int, base_s: float, max_s: float,
                  jitter: float = 0.25,
                  rng: Optional[random.Random] = None) -> float:
    """Delay before retry ``attempt`` (1-based): ``base * 2^(attempt-1)``
    capped at ``max_s``, with +-``jitter`` relative noise so workers
    retrying the same dead filer do not retry in lockstep."""
    delay = min(float(max_s), float(base_s) * (2.0 ** max(0, attempt - 1)))
    if jitter:
        r = rng.random() if rng is not None else random.random()
        delay *= 1.0 + jitter * (2.0 * r - 1.0)
    return max(0.0, delay)


def retry_transient(fn: Callable, retries: int = 3, base_s: float = 0.5,
                    max_s: float = 8.0, jitter: float = 0.25,
                    retryable: Tuple[Type[BaseException], ...] = (OSError,),
                    on_retry: Optional[Callable] = None,
                    sleep_fn: Callable[[float], None] = time.sleep,
                    rng: Optional[random.Random] = None):
    """Run ``fn`` retrying ``retryable`` errors up to ``retries`` extra
    attempts with capped exponential backoff.  ``on_retry(attempt, delay,
    exc)`` observes each retry; its own failures are swallowed."""
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = backoff_delay(attempt, base_s, max_s, jitter, rng)
            if on_retry is not None:
                try:
                    on_retry(attempt, delay, e)
                except Exception as oe:
                    logger.warning(f"retry observer failed: {oe}")
            sleep_fn(delay)


# --------------------------------------------------------------------------- #
# Preemption
# --------------------------------------------------------------------------- #
def resolve_probe(spec: str) -> Optional[Callable[[], bool]]:
    """``"pkg.mod:callable"`` → the callable (a cloud-metadata preemption
    probe returning truthy when the host is marked for reclamation).
    Empty spec → None; an unresolvable spec warns and disables the probe
    rather than killing startup."""
    if not spec:
        return None
    try:
        mod_name, _, attr = spec.partition(":")
        fn = getattr(importlib.import_module(mod_name), attr)
        if not callable(fn):
            raise TypeError(f"{spec} is not callable")
        return fn
    except Exception as e:
        logger.warning(f"preemption probe {spec!r} unavailable: {e}")
        return None


class PreemptionHandler:
    """Turns a preemption *notice* into a cooperative shutdown *flag*.

    ``install()`` chains onto SIGTERM: the notice sets the flag and is
    otherwise swallowed (no re-raise to the default action — the grace
    window exists precisely so the engine can finish a final checkpoint;
    install this handler BEFORE the watchdog so the watchdog's chain ends
    here instead of at SIG_DFL).  A pluggable ``probe`` covers clouds
    that signal reclamation via metadata instead of (or earlier than)
    SIGTERM; ``poll_s > 0`` watches it from a daemon thread, and
    :meth:`check` probes synchronously.

    The engine reads :attr:`triggered` at every optimizer-step boundary
    (after a graphed step's replay: a replay runs no host code) and runs
    its preemption exit (final synchronous checkpoint, telemetry
    ``preemption`` record, ``SystemExit(PREEMPTION_EXIT_CODE)``).
    """

    def __init__(self, probe: Optional[Callable[[], bool]] = None,
                 poll_s: float = 0.0, telemetry=None):
        self.probe = probe
        self.poll_s = float(poll_s or 0.0)
        self.telemetry = telemetry
        self.reason: Optional[str] = None
        self._event = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_handler = None
        self._installed = False

    # -- signal path ----------------------------------------------------- #
    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        try:
            self._prev_handler = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        except (ValueError, OSError) as e:      # non-main thread / exotic env
            logger.warning(f"preemption handler: cannot install SIGTERM: {e}")
        return self

    def _on_signal(self, signum, frame):
        self.trigger(f"signal:{signum}")
        prev = self._prev_handler
        if callable(prev):
            try:
                prev(signum, frame)
            except Exception as e:
                logger.warning(f"chained SIGTERM handler failed: {e}")
        # SIG_DFL/SIG_IGN: swallow — termination happens cooperatively

    # -- probe path ------------------------------------------------------- #
    def start(self) -> "PreemptionHandler":
        if self.probe is not None and self.poll_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._poll_loop, name="preemption-probe", daemon=True)
            self._thread.start()
        return self

    def _poll_loop(self):
        while not self._stop.wait(self.poll_s):
            if self.check():
                return

    def check(self) -> bool:
        """Probe once (if a probe is configured) and return the flag."""
        if not self._event.is_set() and self.probe is not None:
            try:
                if self.probe():
                    self.trigger("probe")
            except Exception as e:
                logger.warning(f"preemption probe failed: {e}")
        return self._event.is_set()

    # -- flag ------------------------------------------------------------- #
    def trigger(self, reason: str):
        if self._event.is_set():
            return
        self.reason = reason
        self._event.set()
        logger.warning(f"preemption notice ({reason}); will checkpoint and "
                       f"exit at the next step boundary")
        if self.telemetry is not None:
            try:
                self.telemetry.emit("preemption",
                                    {"phase": "notice", "reason": reason})
                self.telemetry.flush()
            except Exception as e:
                logger.warning(f"preemption telemetry failed: {e}")

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1.0)
            self._thread = None
        if self._installed:
            try:
                # restore only if still ours — the watchdog restores its own
                if signal.getsignal(signal.SIGTERM) == self._on_signal:
                    signal.signal(signal.SIGTERM, self._prev_handler)
            except (ValueError, OSError):
                pass
            self._installed = False
