"""Checkpoint fault taxonomy and transient-error retry (counterpart of the
checkpoint part of ``deepspeed_tpu/runtime/fault_tolerance.py``).

* :func:`retry_transient` / :func:`backoff_delay` — capped exponential
  backoff with jitter, injectable clock and rng so tests never sleep;
* the checkpoint errors (:class:`CheckpointWriteError`,
  :class:`CheckpointCorruptError`).

The preemption handler (SIGTERM or a cloud probe turned into a final
checkpoint and exit 143) is not ported yet: ROADMAP.md, Queue 1 item 8.
Standard library only.
"""

import random
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger


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
