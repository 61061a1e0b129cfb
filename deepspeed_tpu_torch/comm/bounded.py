"""Bounded execution — deadlines instead of infinite hangs (counterpart
of ``deepspeed_tpu/comm/bounded.py``).

``BoundedCollective`` runs a device-blocking callable on a worker thread;
the caller waits ``deadline_s`` and, on expiry, raises
:class:`CollectiveTimeout` instead of hanging.  The serving engine bounds
its step dispatch with it (``serve_step_timeout_s``): the model step and
the copy of its tokens to the host run on the worker, so a step whose
device work never finishes parks the worker, not the engine.

Threads cannot be killed in Python, so a timed-out worker is
*abandoned*: it stays parked on its (daemon) thread until the wedged
call returns or the process exits, and the next ``run`` gets a fresh
worker with a fresh queue, unless an abandoned worker's call has ended
by then: that worker is taken back, with what its thread has made on
first use (on the card, its cuBLAS handles: a thread that made none
cannot make them inside a stream capture).  The abandoned count is
visible in :meth:`BoundedCollective.stats`.

On the card a worker thread starts on device 0 and on that device's
default stream.  Give ``device`` and ``stream`` and every worker makes
``device`` current and runs the callable under ``stream`` (the caller's
stream), so the work it launches is ordered with the caller's own.  What
a deadline can free is a host thread that is parked: a CUDA kernel that
never returns leaves the context unusable, and nothing in the process
clears that.

Standard library only at import; torch is imported where a worker enters
the device and stream it was given.
"""

import queue
import threading


class CollectiveTimeout(RuntimeError):
    """A bounded call exceeded its deadline: ``op`` labels the call,
    ``deadline_s`` is the bound that expired."""

    def __init__(self, message, op=None, deadline_s=None):
        super().__init__(message)
        self.op = op
        self.deadline_s = deadline_s
        self.job = None          # the abandoned call (``_Job``), set by run()


class _Job:
    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error = None


class BoundedCollective:
    """Run device-blocking work with a deadline on a reusable worker.

    ``deadline_s`` None or <= 0 runs every call inline on the caller's
    thread.  ``on_timeout`` is an optional callable fired (with the
    :class:`CollectiveTimeout` about to be raised) before raising — the
    serving engine uses it to release interruptible fault-injection wedges
    so an abandoned worker can drain instead of leaking.  ``device`` /
    ``stream``: the CUDA device and stream every worker runs the callable
    on (see the module docstring).
    """

    def __init__(self, deadline_s=None, on_timeout=None, device=None, stream=None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self.device = device
        self.stream = stream
        self._lock = threading.Lock()
        self._worker = None            # guarded-by: _lock
        self._queue = None             # guarded-by: _lock
        self._generation = 0           # guarded-by: _lock
        self._parked = []              # guarded-by: _lock; abandoned (worker, queue, job)
        self.abandoned = 0             # workers left wedged on a timeout
        self.timeouts = 0
        self.calls = 0

    # -- worker plumbing ---------------------------------------------------- #

    def _worker_main(self, q):
        if self.stream is not None or (self.device is not None
                                       and getattr(self.device, "type", None) == "cuda"):
            import torch
            if self.device is not None:
                torch.cuda.set_device(self.device)
            if self.stream is not None:
                torch.cuda.set_stream(self.stream)
        while True:
            job = q.get()
            if job is None:
                return
            try:
                job.result = job.fn()
            except BaseException as e:      # propagate to the caller
                job.error = e
            finally:
                job.done.set()

    def _ensure_worker(self):
        # requires-lock: _lock
        if self._worker is None or not self._worker.is_alive():
            for i, (worker, q, job) in enumerate(self._parked):
                if job.done.is_set() and worker.is_alive():
                    # the abandoned call ended: its worker waits on its queue
                    del self._parked[i]
                    self._worker, self._queue = worker, q
                    return q
            self._queue = queue.SimpleQueue()
            self._generation += 1
            self._worker = threading.Thread(
                target=self._worker_main, args=(self._queue,),
                name="dst-bounded-%d" % self._generation, daemon=True)
            self._worker.start()
        return self._queue

    # -- API ----------------------------------------------------------------- #

    def run(self, fn, op="collective", noun="collective"):
        """Execute ``fn()`` under the deadline.  ``op`` and ``noun`` label
        the bounded work in the timeout message — the serving engine bounds
        *step* dispatches and must not report them as collectives."""
        bound = self.deadline_s
        if not bound or bound <= 0.0:
            return fn()

        self.calls += 1
        job = _Job(fn)
        with self._lock:
            q = self._ensure_worker()
        q.put(job)
        if not job.done.wait(bound):
            with self._lock:
                self._parked.append((self._worker, self._queue, job))
                self._worker = None
                self._queue = None
                self.abandoned += 1
            self.timeouts += 1
            err = CollectiveTimeout("%s %r exceeded its %.3fs deadline" % (noun, op, bound),
                                    op=op, deadline_s=float(bound))
            # the abandoned call: a caller that frees it (a released wedge)
            # may wait on ``err.job.done`` and read what it left
            err.job = job
            if self.on_timeout is not None:
                try:
                    self.on_timeout(err)
                except Exception:
                    pass
            raise err
        if job.error is not None:
            raise job.error
        return job.result

    def stats(self):
        return {"calls": self.calls, "timeouts": self.timeouts,
                "abandoned": self.abandoned,
                "deadline_s": self.deadline_s}

    def shutdown(self):
        """Stop the idle worker (wedged workers are already abandoned)."""
        with self._lock:
            q, self._queue = self._queue, None
            self._worker = None
            parked, self._parked = self._parked, []
        for queue_ in [q] + [pq for _, pq, _ in parked]:
            if queue_ is not None:
                queue_.put(None)
