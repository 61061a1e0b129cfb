"""Span-based distributed tracing — the "where inside a step" layer
(counterpart of ``deepspeed_tpu/telemetry/tracing.py``; the spans, the
global tracer and the Chrome-trace document are the JAX package's).

The :class:`~deepspeed_tpu_torch.telemetry.hub.TelemetryHub` answers *how fast*
a step was; the :class:`Tracer` answers *where inside the step the time
went*.  Engines and the comm facade open nested spans around phases
(``fwd``/``bwd``/``step``), collectives (``comm.all_reduce``), pipeline
schedule slots, inference prefill/decode, and checkpoint save/load.

Design constraints (shared with the hub):

* **Zero-sync.**  Opening/closing a span is two ``time.monotonic_ns``
  reads and a list append.  Attribute values are stored by reference —
  a CUDA tensor attr is never copied to the host until export (and
  the flight recorder deliberately never reads it at all: a read blocks
  during the very hangs it exists to diagnose).
* **Monotonic clock only for durations.**  Wall-clock time appears in
  exactly one place — the per-tracer clock anchor used by
  ``tools/trace_merge.py`` to align rank timelines — and is statically
  policed by ``tools/check_monotonic.py``.
* **Double-duty annotation.**  While ``torch.profiler`` records (a
  ``ProfilerWindow`` capture), ``span()`` also enters
  ``torch.profiler.record_function`` so that the span shows in the
  profiler's trace under the same name, where the JAX package enters
  ``jax.named_scope``.  With no profiler recording it enters nothing.
* **Bounded memory.**  Completed spans live in a ring (``capacity``);
  overflow increments ``dropped`` instead of growing without bound.

Export is Chrome-trace / Perfetto JSON (``traceEvents`` with complete
``X`` duration events), one file per rank; ``tools/trace_merge.py`` folds
N rank files onto one clock-aligned timeline.
"""

import itertools
import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

#: the only clock spans are timed with (see tools/check_monotonic.py)
_mono_ns = time.monotonic_ns

_SCOPE_SANITIZE = re.compile(r"[^A-Za-z0-9_.-]")


def _named_scope(name: str):
    """``torch.profiler.record_function`` with a sanitized name while a
    profiler records; inert otherwise, or if torch rejects the name
    (tracing must never be a reason to crash)."""
    try:
        from torch.autograd import profiler as _prof
        if not _prof._is_profiler_enabled:
            return nullcontext()
        return _prof.record_function(_SCOPE_SANITIZE.sub("_", name) or "span")
    except Exception:
        return nullcontext()


class Tracer:
    """Nested context-manager span recorder with Chrome-trace export.

    ``clock`` is injectable for tests and must be a nanosecond monotonic
    clock.  ``heartbeat`` (optional) is invoked on every span open — the
    hang watchdog registers its ``pet`` here so each phase/collective
    span doubles as a liveness beat.
    """

    def __init__(self, rank: int = 0, capacity: int = 65536,
                 clock: Optional[Callable[[], int]] = None,
                 heartbeat: Optional[Callable[[], None]] = None,
                 use_named_scope: bool = True):
        self.rank = int(rank)
        self.capacity = max(1, int(capacity))
        self._clock = clock or _mono_ns
        self.heartbeat = heartbeat
        self.use_named_scope = use_named_scope
        self.completed = deque(maxlen=self.capacity)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._open: Dict[int, List[Dict[str, Any]]] = {}  # tid -> span stack
        self.epoch_ns = self._clock()
        # The single sanctioned wall-clock read: trace_merge aligns rank
        # timelines by mapping each tracer's monotonic epoch to wall time.
        self.epoch_wall_ns = time.time_ns()  # wall-clock anchor: ok
        self.closed = False

    # -- recording (zero-sync hot path) -------------------------------- #
    def _stack(self) -> List[Dict[str, Any]]:
        tid = threading.get_ident()
        stack = self._open.get(tid)
        if stack is None:
            stack = self._open[tid] = []
        return stack

    def _append(self, rec: Dict[str, Any]):
        if len(self.completed) == self.capacity:
            self.dropped += 1
        self.completed.append(rec)

    @contextmanager
    def span(self, name: str, **args):
        """Open a nested span; attributes are stored by reference (never
        read here).  Also enters ``record_function(name)`` while a
        profiler records, so the span is named in its trace."""
        if self.closed:
            yield
            return
        if self.heartbeat is not None:
            self.heartbeat()
        stack = self._stack()
        rec = {
            "sid": next(self._ids),
            "name": name,
            "t0": self._clock(),
            "t1": None,
            "tid": threading.get_ident(),
            "depth": len(stack),
            "parent": stack[-1]["sid"] if stack else 0,
            "args": args or None,
        }
        stack.append(rec)
        scope = _named_scope(name) if self.use_named_scope else nullcontext()
        try:
            with scope:
                yield rec
        finally:
            rec["t1"] = self._clock()
            if stack and stack[-1] is rec:
                stack.pop()
            else:  # defensive: unbalanced exit from another thread/path
                try:
                    stack.remove(rec)
                except ValueError:
                    pass
            self._append(rec)

    def instant(self, name: str, **args):
        """Zero-duration marker (Chrome ``ph: "i"``) — e.g. a collective
        recorded at trace time, where host-side duration is meaningless."""
        if self.closed:
            return
        stack = self._stack()
        self._append({
            "sid": next(self._ids), "name": name, "t0": self._clock(),
            "t1": None, "tid": threading.get_ident(), "depth": len(stack),
            "parent": stack[-1]["sid"] if stack else 0,
            "args": args or None, "instant": True,
        })

    def add_span(self, name: str, t0_ns: int, t1_ns: int,
                 track: Optional[str] = None, **args):
        """Record a retrospective span with explicit timestamps (used for
        synthetic tracks, e.g. the pipeline schedule-slot timeline).
        ``track`` names a virtual thread lane in the exported trace."""
        if self.closed:
            return
        self._append({
            "sid": next(self._ids), "name": name, "t0": int(t0_ns),
            "t1": int(t1_ns), "tid": track or threading.get_ident(),
            "depth": 0, "parent": 0, "args": args or None,
        })

    # -- introspection (flight recorder / tests) ------------------------ #
    def open_spans(self) -> List[Dict[str, Any]]:
        """Snapshot of every currently-open span across all threads (the
        flight recorder dumps these on a stall).  Values are copied
        shallowly; attrs stay unforced."""
        out = []
        for tid, stack in list(self._open.items()):
            for rec in list(stack):
                out.append(dict(rec))
        return out

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Most-recent completed spans, newest last."""
        recs = list(self.completed)
        return recs if limit is None else recs[-int(limit):]

    # -- export ---------------------------------------------------------- #
    def _args_host(self, args):
        if not args:
            return None
        from deepspeed_tpu_torch.telemetry.hub import _to_host
        try:
            return {k: _to_host(v) for k, v in args.items()}
        except Exception:
            return {k: str(type(v).__name__) for k, v in args.items()}

    def _tid_index(self, tids) -> Dict[Any, int]:
        """Stable small integers per lane: real thread ids first (main
        thread = 0), then named synthetic tracks."""
        ints = sorted(t for t in tids if isinstance(t, int))
        names = sorted(str(t) for t in tids if not isinstance(t, int))
        main = threading.main_thread().ident
        if main in ints:
            ints.remove(main)
            ints.insert(0, main)
        index = {t: i for i, t in enumerate(ints)}
        index.update({n: len(ints) + i for i, n in enumerate(names)})
        return index

    def to_chrome_events(self) -> List[Dict[str, Any]]:
        """Completed spans as Chrome-trace ``traceEvents`` (ts/dur in µs,
        relative to this tracer's monotonic epoch)."""
        recs = self.snapshot()
        tid_of = self._tid_index({r["tid"] for r in recs})
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": self.rank, "tid": 0,
             "ts": 0, "args": {"name": f"rank {self.rank}"}},
            {"ph": "M", "name": "process_sort_index", "pid": self.rank,
             "tid": 0, "ts": 0, "args": {"sort_index": self.rank}},
        ]
        for tid, i in tid_of.items():
            name = tid if isinstance(tid, str) else (
                "main" if tid == threading.main_thread().ident
                else f"thread-{i}")
            events.append({"ph": "M", "name": "thread_name", "pid": self.rank,
                           "tid": i, "ts": 0, "args": {"name": name}})
        for r in recs:
            ev = {
                "name": r["name"],
                "cat": str(r["name"]).split(".", 1)[0],
                "pid": self.rank,
                "tid": tid_of[r["tid"]],
                "ts": (r["t0"] - self.epoch_ns) / 1e3,
            }
            args = self._args_host(r.get("args"))
            if args:
                ev["args"] = args
            if r.get("instant"):
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                t1 = r["t1"] if r["t1"] is not None else r["t0"]
                ev["dur"] = max((t1 - r["t0"]) / 1e3, 0.0)
            events.append(ev)
        return events

    def export_chrome_trace(self, path: str) -> str:
        """Write this rank's timeline as a Perfetto-loadable JSON object.
        ``metadata.clock_sync`` carries the monotonic→wall anchor that
        ``tools/trace_merge.py`` uses for cross-rank alignment."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        doc = {
            "traceEvents": self.to_chrome_events(),
            "displayTimeUnit": "ms",
            "metadata": {
                "rank": self.rank,
                "dropped_spans": self.dropped,
                "clock_sync": {"mono_ns": self.epoch_ns,
                               "wall_ns": self.epoch_wall_ns},
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        logger.info(f"tracer: wrote {len(doc['traceEvents'])} events -> {path}")
        return path

    def close(self):
        self.closed = True


# --------------------------------------------------------------------------- #
# Global tracer registry — the instrumentation points (comm facade,
# checkpointing, engines built without an explicit tracer) look here.
# --------------------------------------------------------------------------- #
_GLOBAL_TRACER: Optional[Tracer] = None


def set_global_tracer(tracer: Optional[Tracer]):
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = tracer


def get_global_tracer() -> Optional[Tracer]:
    return _GLOBAL_TRACER


def maybe_span(name: str, tracer: Optional[Tracer] = None, **args):
    """A span on ``tracer`` (else the global tracer), or an inert context
    when tracing is off — the one-liner instrumentation points use."""
    t = tracer if tracer is not None else _GLOBAL_TRACER
    return t.span(name, **args) if t is not None else nullcontext()


def export_rank_trace(tracer: Tracer, trace_dir: str) -> None:
    """Export ``tracer`` to ``trace_dir/trace_rank<rank>.json``, the name
    ``tools/trace_merge.py`` folds, when ``trace_dir`` is set.  A failure
    is logged, not raised: closing an engine never fails on its trace."""
    if not trace_dir:
        return
    try:
        tracer.export_chrome_trace(os.path.join(trace_dir, f"trace_rank{tracer.rank}.json"))
    except Exception as e:
        logger.warning(f"chrome-trace export failed: {e}")


# --------------------------------------------------------------------------- #
# ZeRO-3 schedule lanes — the compute/communication overlap record.  No
# engine of the port calls this: its stage 3 gathers block by block with
# nothing overlapped, which is neither lane set drawn here.
# --------------------------------------------------------------------------- #
def emit_zero3_schedule(tracer: Tracer, t0_ns: int, t1_ns: int,
                        n_blocks: int, layered: bool, depth: int = 1,
                        offload: bool = False):
    """Emit synthetic ``zero3.comm`` / ``zero3.compute`` lanes describing
    the stage-3 step's dependence structure inside the measured fwd window.

    Host-side spans fire at TRACE time (they nest inside the fwd span and
    observe no device concurrency), so real gather/compute simultaneity is
    invisible to the tracer.  What IS knowable host-side is the schedule
    the program structure admits — the same convention the pipeline
    schedule-slot lanes use.  The bulk step's all-gather strictly precedes
    the first block and its reduce-scatter strictly follows the last
    (overlap fraction ~0); the layered step issues block *i+depth*'s
    gather alongside block *i*'s compute and block *i*'s reduce-scatter
    alongside the backward of block *i+1* (overlap fraction L/(L+2)).

    ``tools/trace_merge.py`` computes the overlap fraction from these
    lanes via interval intersection on ``args.kind``.
    """
    L = max(1, int(n_blocks))
    span = max(1, int(t1_ns) - int(t0_ns))
    slots = L + 2
    dt = span / slots

    def at(i):
        return int(t0_ns + i * dt)

    if layered:
        for i in range(L):
            if offload:
                # the host→HBM stage of slice i rides the same ring slot
                # as its gather (it feeds the gather's wire bytes), hidden
                # under block i-depth's compute like the collective
                tracer.add_span("offload.stage", at(i), at(i + 1),
                                track="offload.stage", kind="comm",
                                block=i, depth=depth)
            tracer.add_span("zero3.gather", at(i), at(i + 1),
                            track="zero3.comm", kind="comm", block=i,
                            depth=depth)
            tracer.add_span("zero3.block", at(i + 1), at(i + 2),
                            track="zero3.compute", kind="compute", block=i)
            tracer.add_span("zero3.reduce_scatter", at(i + 2), at(i + 3),
                            track="zero3.comm", kind="comm", block=i)
    else:
        tracer.add_span("zero3.all_gather", at(0), at(1),
                        track="zero3.comm", kind="comm")
        for i in range(L):
            tracer.add_span("zero3.block", at(i + 1), at(i + 2),
                            track="zero3.compute", kind="compute", block=i)
        tracer.add_span("zero3.reduce_scatter", at(L + 1), at(L + 2),
                        track="zero3.comm", kind="comm")
