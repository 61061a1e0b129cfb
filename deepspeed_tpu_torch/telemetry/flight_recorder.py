"""Flight recorder — crash-safe post-mortem dumps for hangs and kills
(counterpart of ``deepspeed_tpu/telemetry/flight_recorder.py``; the dump
file is the JAX package's, and its ``read_dump`` reads the port's).

When the watchdog fires (or a SIGTERM/SIGABRT lands), this module writes
everything needed to reconstruct "what was every thread doing, and what
was the last telemetry the run produced" to an append-only JSONL file:

* the telemetry ring buffer (already-flushed, host-side records),
* the hub's *pending* records with device tensors replaced by shape /
  dtype / device placeholders — **never read**: a ``.cpu()`` of a CUDA
  tensor waits on its stream, i.e. on the very hang being diagnosed,
* all currently-open tracer spans plus a tail of completed ones,
* a Python stack for every live thread (``sys._current_frames``).

Crash-safety: the file is opened in append mode, every record is written
as one line and flushed immediately, and the file is fsync'd at the end
— a SIGKILL halfway through still leaves a parseable prefix.  Timing
uses ``time.monotonic_ns`` only (see ``tools/check_monotonic.py``).
"""

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List

from deepspeed_tpu_torch.utils.logging import logger

_mono_ns = time.monotonic_ns

DUMP_SCHEMA_VERSION = 1


def _hang_safe(value: Any) -> Any:
    """JSON-ready view of a value that must not block: tensors (and
    anything else exotic) become descriptive placeholders instead of
    being copied to the host."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _hang_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_hang_safe(v) for v in value]
    if _is_tensor(value):  # do NOT read it: on a wedged stream that hangs
        dtype = str(value.dtype).replace("torch.", "")
        return (f"<unforced {type(value).__name__} "
                f"{dtype}{list(value.shape)} on {value.device}>")
    try:
        import numpy as np
        if isinstance(value, np.generic):
            return value.item()
        if isinstance(value, np.ndarray):
            return value.tolist() if value.size <= 16 else (
                f"<ndarray shape={value.shape} dtype={value.dtype}>")
    except Exception:
        pass
    return f"<{type(value).__name__}>"


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


def thread_stacks() -> List[Dict[str, Any]]:
    """One entry per live thread: name, ident, daemon flag, and the
    current Python stack (outermost frame first)."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append({
            "thread_id": ident,
            "name": t.name if t else "<unknown>",
            "daemon": bool(t.daemon) if t else None,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    return out


class FlightRecorder:
    """Aggregates hub + tracer state into a post-mortem JSONL dump.

    ``dump(reason)`` is the watchdog's ``on_stall`` payload (via
    :meth:`on_stall`) and is safe to call from signal handlers and
    watchdog threads: no device sync, no allocation beyond the dump
    itself, best-effort on every sub-section.
    """

    def __init__(self, dump_dir: str, rank: int = 0, hub=None, tracer=None,
                 span_tail: int = 256, collective_monitor=None,
                 collective_tail: int = 64):
        self.dump_dir = dump_dir
        self.rank = int(rank)
        self.hub = hub
        self.tracer = tracer
        self.span_tail = int(span_tail)
        self.collective_monitor = collective_monitor
        self.collective_tail = int(collective_tail)
        self._seq = 0
        self._lock = threading.Lock()

    # adapter matching HangWatchdog's on_stall signature
    def on_stall(self, watchdog, stalled_for_s: float, what: str) -> str:
        what = what or "unknown"
        # signal-origin dumps are already fully qualified ("signal:15")
        reason = what if what.startswith("signal:") else f"stall:{what}"
        return self.dump(reason=reason, stalled_for_s=stalled_for_s)

    # -- section builders (each individually best-effort) --------------- #
    def _ring_records(self) -> List[Dict[str, Any]]:
        hub = self.hub
        if hub is None:
            return []
        ring = getattr(hub, "ring", None)   # hub's RingBufferSink, if any
        if ring is None:
            return []
        return [_hang_safe(r) for r in list(ring.records)]

    def _pending_records(self) -> List[Dict[str, Any]]:
        # Unflushed hub records may hold in-flight device values; keep
        # them unforced.
        hub = self.hub
        if hub is None:
            return []
        return [_hang_safe(r) for r in list(getattr(hub, "_pending", []))]

    def _collectives(self) -> Dict[str, Any]:
        # last-N ring records: a wedge dump names the stuck collective —
        # an open record (t_exit_us None) at the tail IS the wedge
        mon = self.collective_monitor
        if mon is None:
            return {"records": [], "seq": 0, "desync_count": 0}
        out = {
            "records": mon.last_records(self.collective_tail),
            "seq": mon.seq,
            "desync_count": mon.desync_count,
        }
        if mon.last_desync is not None:
            out["last_desync"] = _hang_safe(mon.last_desync)
        return out

    def _spans(self) -> Dict[str, Any]:
        tr = self.tracer
        if tr is None:
            return {"open": [], "recent": []}
        return {
            "open": [_hang_safe(r) for r in tr.open_spans()],
            "recent": [_hang_safe(r) for r in tr.snapshot(self.span_tail)],
        }

    def dump(self, reason: str = "manual", stalled_for_s: float = 0.0) -> str:
        """Write one dump (header + sections, one JSON object per line)
        and return its path.  Never raises."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        path = os.path.join(
            self.dump_dir, f"flight_rank{self.rank}_{seq}.jsonl")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            f = open(path, "a")
        except OSError as e:
            logger.error(f"flight recorder: cannot open {path}: {e}")
            return path

        def emit(section: str, payload):
            try:
                rec = {"section": section, "payload": payload}
                f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
            except Exception as e:
                logger.error(f"flight recorder: section {section} failed: {e}")

        try:
            emit("header", {
                "schema_version": DUMP_SCHEMA_VERSION,
                "rank": self.rank,
                "pid": os.getpid(),
                "reason": reason,
                "stalled_for_s": stalled_for_s,
                "mono_ns": _mono_ns(),
            })
            emit("ring_buffer", self._ring_records())
            emit("pending_records", self._pending_records())
            spans = self._spans()
            emit("open_spans", spans["open"])
            emit("recent_spans", spans["recent"])
            emit("thread_stacks", thread_stacks())
            emit("collectives", self._collectives())
            emit("end", {"complete": True})
        finally:
            try:
                f.flush()
                os.fsync(f.fileno())
            except OSError:
                pass
            f.close()
        logger.error(f"flight recorder: dumped state ({reason}) -> {path}")
        return path


def read_dump(path: str) -> Dict[str, List[Any]]:
    """Parse a dump back into ``{section: [payloads...]}`` — tolerant of
    a truncated final line (the SIGKILL case)."""
    sections: Dict[str, List[Any]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # truncated tail — keep what we have
            sections.setdefault(rec.get("section", "?"), []).append(
                rec.get("payload"))
    return sections
