"""TelemetryHub — the structured event bus every engine emits into
(counterpart of ``deepspeed_tpu/telemetry/hub.py``; the records, the JSONL
file and its rotation are the JAX package's).

Design constraints (the point of this module):

* **Telemetry-off costs nothing.**  Engines hold ``telemetry = None`` when
  the config block is absent; no code path below ever runs.
* **Telemetry-on never syncs the device per step.**  ``record_step`` only
  appends a dict whose values may still be device tensors that the card
  has not computed yet — the same windowed-drain discipline as
  ``ThroughputTimer``.  One device drain happens per flush window
  (default: the engine's report boundary): the devices of the buffered
  tensors are synchronized once, every buffered tensor is flattened into
  one float64 vector a device, and each vector comes to the host in one
  ``.cpu()`` — never an ``.item()`` a value.
* **Sinks are pluggable.**  A rank-0 append-only JSONL file (schema-
  versioned, consumed by ``tools/telemetry_report.py``), an in-memory ring
  buffer queryable from tests, and ``MonitorSink`` over any object with
  ``write_events`` (the port has no ``MonitorMaster`` writers yet: the
  monitor blocks raise, ROADMAP.md, Queue 1 item 9).

``telemetry_from_arg`` resolves an engine's ``telemetry=`` / ``tracer=``
arguments, building from a config dict the hub (and tracer) that the
engine owns and closes (``OwnedTelemetry``).
"""

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.telemetry import events
from deepspeed_tpu_torch.telemetry import stats as _stats
from deepspeed_tpu_torch.utils.logging import logger


def _to_host(value: Any) -> Any:
    """JSON-ready host value from a (ready) tensor / numpy / scalar."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        value = value.numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_host(v) for v in value]
    try:
        arr = np.asarray(value)
    except Exception:
        return str(value)
    if arr.ndim == 0 and arr.dtype.kind == "O":
        return str(value)
    if arr.ndim == 0:
        if arr.dtype.kind == "b":
            return bool(arr)
        if arr.dtype.kind in "iu":
            return int(arr)
        return float(arr)
    return arr.tolist()


def _tensors_in(value: Any, out: List[torch.Tensor]) -> None:
    if isinstance(value, torch.Tensor):
        out.append(value)
    elif isinstance(value, dict):
        for v in value.values():
            _tensors_in(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _tensors_in(v, out)


def _replace_tensors(value: Any, host: Dict[int, np.ndarray]) -> Any:
    if isinstance(value, torch.Tensor):
        return host.get(id(value), value)
    if isinstance(value, dict):
        return {k: _replace_tensors(v, host) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_replace_tensors(v, host) for v in value)
    return value


def _host_dtype(dtype: torch.dtype):
    if dtype == torch.bool:
        return np.bool_
    if dtype.is_floating_point:
        return np.float64
    return np.int64


def drain_tensors(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``records`` with every device tensor in them replaced by a numpy
    array of its value: the tensors of each device are flattened into one
    float64 vector and copied to the host in one ``.cpu()`` (a CPU tensor
    is read as it is).  The caller has synchronized the devices."""
    found: List[torch.Tensor] = []
    for rec in records:
        _tensors_in(rec, found)
    if not found:
        return records
    by_device: Dict[torch.device, List[torch.Tensor]] = {}
    seen = set()
    for t in found:
        if id(t) not in seen:
            seen.add(id(t))
            by_device.setdefault(t.device, []).append(t)
    host: Dict[int, np.ndarray] = {}
    for device, tensors in by_device.items():
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
            flat = flat.cpu().numpy()
        pos = 0
        for t in tensors:
            n = t.numel()
            host[id(t)] = flat[pos:pos + n].reshape(tuple(t.shape)).astype(_host_dtype(t.dtype))
            pos += n
    return [_replace_tensors(rec, host) for rec in records]


def cuda_devices_of(records: List[Dict[str, Any]]) -> List[torch.device]:
    """The CUDA devices that the records' tensors live on."""
    found: List[torch.Tensor] = []
    for rec in records:
        _tensors_in(rec, found)
    return sorted({t.device for t in found if t.device.type == "cuda"},
                  key=lambda d: d.index or 0)


def device_memory_stats(device) -> Dict[str, int]:
    """``torch.cuda.memory_stats`` of a CUDA ``device`` under the JAX
    package's key names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``), so that the records' schema does not change; ``{}``
    for another device."""
    if device is None or torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}


# --------------------------------------------------------------------------- #
# Sinks
# --------------------------------------------------------------------------- #
class TelemetrySink:
    """Interface: receives fully-drained (host-value) records."""

    def write(self, records: List[Dict[str, Any]]):
        raise NotImplementedError

    def close(self):
        ...


class JsonlSink(TelemetrySink):
    """Append-only JSONL file, rank-0 only.  The first line of a fresh file
    is a ``schema`` header record so the file is self-describing.

    Size-capped rotation (``max_bytes`` > 0): when the live file passes the
    cap it is renamed to ``path.N`` (N ascending = chronological) and a
    fresh header-bearing file is opened; at most ``keep`` rotated files are
    retained.  Readers go through ``telemetry.stats.load_records``, which
    walks the rotated set transparently."""

    def __init__(self, path: str, rank: int = 0, max_bytes: int = 0,
                 keep: int = 5):
        self.path = path
        self.rank = rank
        self.max_bytes = int(max_bytes or 0)
        self.keep = max(1, int(keep))
        self._fh = None

    def _ensure_open(self):
        if self._fh is not None:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fresh = not (os.path.exists(self.path) and os.path.getsize(self.path) > 0)
        self._fh = open(self.path, "a")
        if fresh:
            header = events.make_record(events.SCHEMA,
                                        {"version": events.SCHEMA_VERSION,
                                         "created_unix": time.time()})
            self._fh.write(json.dumps(header) + "\n")

    def write(self, records):
        if self.rank != 0 or not records:
            return
        self._ensure_open()
        for rec in records:
            self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.max_bytes and self._fh.tell() >= self.max_bytes:
            self._rotate()

    def _rotate(self):
        self._fh.close()
        self._fh = None
        rotated = [p for p in _stats.rotated_set(self.path)
                   if p != self.path and os.path.exists(p)]
        next_idx = 1
        if rotated:
            next_idx = max(int(p.rsplit(".", 1)[1]) for p in rotated) + 1
        try:
            os.replace(self.path, f"{self.path}.{next_idx}")
        except OSError as e:
            logger.warning(f"telemetry jsonl rotation failed: {e}")
            return
        rotated.append(f"{self.path}.{next_idx}")
        for stale in rotated[:max(0, len(rotated) - self.keep)]:
            try:
                os.remove(stale)
            except OSError:
                pass

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RingBufferSink(TelemetrySink):
    """Bounded in-memory record buffer — the test/debug query surface."""

    def __init__(self, capacity: int = 1024):
        self.records = deque(maxlen=max(1, capacity))

    def write(self, records):
        self.records.extend(records)

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("kind") == kind]

    def last(self, kind: Optional[str] = None) -> Optional[Dict[str, Any]]:
        pool = self.records if kind is None else self.of_kind(kind)
        return pool[-1] if pool else None


class MonitorSink(TelemetrySink):
    """Fan step records out to the existing ``MonitorMaster`` writers as
    ``(name, value, step)`` scalar events (reference monitor convention)."""

    # step-record fields forwarded as monitor scalars
    FIELDS = ("loss", "lr", "grad_norm", "step_time_ms", "samples_per_sec",
              "tflops_per_chip", "comm_bytes", "device_peak_bytes")

    def __init__(self, monitor, prefix: str = "Train/Telemetry"):
        self.monitor = monitor
        self.prefix = prefix

    def write(self, records):
        evs = []
        for rec in records:
            if rec.get("kind") != events.STEP:
                continue
            step = rec.get("step", 0)
            for f in self.FIELDS:
                v = rec.get(f)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    evs.append((f"{self.prefix}/{f}", v, step))
        if evs:
            self.monitor.write_events(evs)


# --------------------------------------------------------------------------- #
# Hub
# --------------------------------------------------------------------------- #
class TelemetryHub:
    """Buffers typed records and drains them to sinks at window boundaries.

    ``flush_every`` step records per window (0/None disables auto-flush —
    callers flush at their own report boundary).  Per-step cost is one dict
    append + one ``time.time()``; the single device drain per window happens
    inside :meth:`flush`.  ``device`` (a CUDA device) is where
    ``device_peak_bytes`` is read; ``sync_fn`` replaces the drain's
    synchronize.

    JAX's ``lr_fn``, ``comms_logger``, ``flops_per_step`` and
    ``memory_stats_fn`` are not taken: the engines record ``lr`` with each
    step, and the comms logger and the flops profiler are not ported
    (ROADMAP.md, Queue 1 items 7 and 9), so a step record's ``comm_bytes``
    and ``comm_ops`` are 0 and it has no ``tflops_per_chip``, as JAX's are
    without those.
    """

    def __init__(self, sinks: Optional[List[TelemetrySink]] = None,
                 flush_every: int = 50,
                 batch_size: int = 1,
                 sync_fn: Optional[Callable[[], None]] = None,
                 device=None):
        self.sinks = list(sinks or [])
        self.flush_every = int(flush_every or 0)
        self.batch_size = max(1, int(batch_size))
        self._sync_fn = sync_fn
        self.device = None if device is None else torch.device(device)
        self._pending: List[Dict[str, Any]] = []
        self._pending_steps = 0
        self._window_t = time.time()     # wall clock of the last drained step
        self.closed = False
        # live observability plane (wired up by from_config when enabled)
        self.registry = None             # metrics.MetricsRegistry
        self.slo_monitor = None          # slo.SLOMonitor, run at flush boundary
        self.obs_server = None           # obs_server.ObsServer
        self.snapshot_every = 0          # cross-rank fold cadence (steps)
        self._last_snapshot_step = None
        # collective health plane (wired up by from_config when enabled)
        self.collective_monitor = None   # collective_monitor.CollectiveMonitor
        self._collective_fed_seq = 0     # last seq whose skew reached the sink
        self._last_collective_health = None
        self._last_step_mono = None
        self._last_flush_mono = time.monotonic()
        # goodput attribution (wired up by from_config when enabled)
        self.ledger = None               # ledger.GoodputLedger
        self.efficiency_json_path = ""   # per-run EFFICIENCY.json artifact
        self._goodput_final = False

    # -- construction ---------------------------------------------------- #
    @classmethod
    def from_config(cls, tcfg, batch_size: int = 1,
                    steps_per_print: Optional[int] = None, device=None):
        """Build the hub + sinks from a ``telemetry`` config block
        (``runtime/config.py:DeepSpeedTelemetryConfig``).  The rank is the
        ``comm/`` process group's (0 without one); ``device`` is the
        engine's.  ``goodput_peak_tflops_per_chip``
        > 0 raises: the MFU gauge it enables needs the flops profiler."""
        from deepspeed_tpu_torch import comm
        if float(getattr(tcfg, "goodput_peak_tflops_per_chip", 0.0) or 0.0) > 0:
            raise NotImplementedError(
                "telemetry.goodput_peak_tflops_per_chip > 0 (the MFU gauge) needs the flops "
                "profiler, which is not ported yet (ROADMAP.md, Queue 1 item 9 (flops "
                "profiler))")
        rank = comm.get_rank()
        sinks: List[TelemetrySink] = []
        if tcfg.jsonl_path:
            sinks.append(JsonlSink(
                tcfg.jsonl_path, rank=rank,
                max_bytes=getattr(tcfg, "jsonl_max_bytes", 0),
                keep=getattr(tcfg, "jsonl_keep", 5)))
        if tcfg.ring_buffer_size:
            sinks.append(RingBufferSink(tcfg.ring_buffer_size))
        flush_every = tcfg.flush_every or steps_per_print or 50
        hub = cls(sinks=sinks, flush_every=flush_every, batch_size=batch_size,
                  device=device)
        if getattr(tcfg, "metrics", True):
            from deepspeed_tpu_torch.telemetry import slo as slo_mod
            from deepspeed_tpu_torch.telemetry.metrics import (MetricsRegistry,
                                                         MetricsSink)
            hub.registry = MetricsRegistry()
            hub.add_sink(MetricsSink(hub.registry))
            hub.snapshot_every = int(getattr(tcfg, "snapshot_every", 0) or 0)
            hub.slo_monitor = slo_mod.SLOMonitor(
                slo_mod.rules_from_config(getattr(tcfg, "slo_rules", None)),
                registry=hub.registry, telemetry=hub)
            if getattr(tcfg, "goodput", True):
                from deepspeed_tpu_torch.telemetry.ledger import GoodputLedger
                hub.ledger = GoodputLedger(
                    registry=hub.registry,
                    hang_threshold_s=(
                        float(getattr(tcfg, "watchdog_timeout_s", 0.0))
                        if getattr(tcfg, "watchdog_enabled", False) else 0.0))
                path = getattr(tcfg, "efficiency_json_path", "") or ""
                if not path and tcfg.jsonl_path:
                    path = os.path.join(os.path.dirname(tcfg.jsonl_path),
                                        "EFFICIENCY.json")
                hub.efficiency_json_path = path
            if getattr(tcfg, "collective_monitor", True):
                from deepspeed_tpu_torch.telemetry.collective_monitor import (
                    CollectiveMonitor)
                hub.collective_monitor = CollectiveMonitor(
                    rank=rank,
                    capacity=int(getattr(tcfg, "collective_ring", 2048)
                                 or 2048))
            if getattr(tcfg, "ops_server", False):
                from deepspeed_tpu_torch.telemetry.obs_server import (
                    ObsServer, collective_desync_health_check)
                hub.obs_server = ObsServer(
                    hub.registry,
                    host=getattr(tcfg, "ops_host", "127.0.0.1"),
                    port=getattr(tcfg, "ops_port", 0),
                    slo_monitor=hub.slo_monitor)
                hub.obs_server.add_health_check("telemetry", hub.health_check)
                if hub.ledger is not None:
                    hub.obs_server.goodput_fn = hub.ledger.snapshot
                if hub.collective_monitor is not None:
                    hub.obs_server.collectives_fn = hub.collective_status
                    hub.obs_server.add_health_check(
                        "collective_desync",
                        collective_desync_health_check(
                            hub.collective_monitor))
                hub.obs_server.start()
        return hub

    # -- sink queries (tests) -------------------------------------------- #
    def add_sink(self, sink: TelemetrySink):
        self.sinks.append(sink)

    @property
    def ring(self) -> Optional[RingBufferSink]:
        for s in self.sinks:
            if isinstance(s, RingBufferSink):
                return s
        return None

    # -- emission (zero-sync hot path) ------------------------------------ #
    def record_step(self, step: int, **fields):
        """Buffer one per-step record.  Values may be device arrays; nothing
        here blocks on the device."""
        if self.closed:
            return
        self._last_step_mono = time.monotonic()
        rec: Dict[str, Any] = {"step": int(step), "_t": time.time()}
        rec.update(fields)
        self._pending.append(events.make_record(events.STEP, rec))
        self._pending_steps += 1
        if self.flush_every and self._pending_steps >= self.flush_every:
            self.flush()

    def emit(self, kind: str, payload: Dict[str, Any], step: Optional[int] = None):
        """Buffer a non-step record (pipe/inference/moe/comm summary)."""
        if self.closed:
            return
        rec = dict(payload)
        if step is not None:
            rec["step"] = int(step)
        self._pending.append(events.make_record(kind, rec))

    # -- drain ------------------------------------------------------------ #
    def _drain_device(self, records):
        """Synchronize the devices that the buffered records' tensors live
        on (or call ``sync_fn``) — the window's one device sync."""
        if self._sync_fn is not None:
            self._sync_fn()
            return
        for device in cuda_devices_of(records):
            torch.cuda.synchronize(device)

    def _device_peak_bytes(self) -> int:
        try:
            stats = device_memory_stats(self.device)
        except Exception:
            stats = {}
        return int(stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0)))

    def flush(self):
        """Drain the device once, resolve buffered values to host floats,
        derive windowed rates, and fan records out to every sink."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._pending_steps = 0
        # the drain exists to materialize buffered device values in step
        # records; a window of host-side event records (worker_exit, SLO
        # transitions, the closing goodput snapshot) must not pay a sync
        if any(rec.get("kind") == events.STEP for rec in pending):
            self._drain_device(pending)
        pending = drain_tensors(pending)
        peak = self._device_peak_bytes()

        out: List[Dict[str, Any]] = []
        prev_t = self._window_t
        for rec in pending:
            if rec.get("kind") != events.STEP:
                out.append({k: _to_host(v) for k, v in rec.items()})
                continue
            t = rec.pop("_t")
            dt = max(t - prev_t, 1e-9)
            resolved = {k: _to_host(v) for k, v in rec.items()}
            resolved["step_time_ms"] = dt * 1000.0
            resolved["samples_per_sec"] = self.batch_size / dt
            resolved["comm_bytes"] = 0       # no comms logger (see the class)
            resolved["comm_ops"] = 0
            resolved["device_peak_bytes"] = peak
            resolved.setdefault("loss", 0.0)
            resolved.setdefault("lr", 0.0)
            out.append(resolved)
            prev_t = t
        self._window_t = prev_t

        # one cumulative goodput snapshot rides every drain window (the
        # close() finalization emits the authoritative last one itself)
        if self.ledger is not None and not self._goodput_final and not any(
                r.get("kind") == events.GOODPUT for r in out):
            try:
                out.append(events.make_record(events.GOODPUT,
                                              self.ledger.snapshot()))
            except Exception as e:
                logger.warning(f"goodput snapshot failed: {e}")

        for sink in self.sinks:
            try:
                sink.write(out)
            except Exception as e:
                logger.warning(f"telemetry sink {type(sink).__name__} failed: {e}")
        self._last_flush_mono = time.monotonic()
        if self.slo_monitor is not None:
            try:
                self.slo_monitor.evaluate()
            except Exception as e:
                logger.warning(f"SLO evaluation failed: {e}")

    # -- live observability plane ----------------------------------------- #
    def maybe_snapshot(self, step: int):
        """Run the cross-rank metrics fold at the configured step cadence
        (``telemetry.snapshot_every``); rank 0's registry then carries the
        pod-level merged snapshot the ops server serves under
        ``dstpu_pod_``."""
        if not (self.registry is not None and self.snapshot_every):
            return
        last = self._last_snapshot_step
        if last is not None and step - last < self.snapshot_every:
            return
        self._last_snapshot_step = step
        from deepspeed_tpu_torch.telemetry import metrics as metrics_mod
        try:
            metrics_mod.cross_rank_snapshot(self.registry)
        except Exception as e:
            logger.warning(f"cross-rank metrics snapshot failed: {e}")
        if self.collective_monitor is not None:
            try:
                self.collective_fold(step=step)
            except Exception as e:
                logger.warning(f"collective health fold failed: {e}")

    def _gather_collective_views(self, view):
        """Per-rank window views for the fold: with a process group of
        more than one rank, every rank's ring is gathered over it
        (``collective_monitor.gather_windows_over_group``: every rank
        must call this at the same point); else this rank's view alone."""
        from deepspeed_tpu_torch import comm
        if comm.get_world_size() <= 1:
            return [view]
        from deepspeed_tpu_torch.telemetry import collective_monitor as cm
        return cm.gather_windows_over_group(
            view, width=self.collective_monitor.capacity)

    def collective_fold(self, step: Optional[int] = None,
                        per_rank_views=None):
        """Fold the per-rank collective windows into one health verdict
        and publish it everywhere: a ``collective_window`` record (this
        rank's ring — the offline fold's input), a ``collective_health``
        record (whose sink handler is the SINGLE feed path for the
        ``dstpu_collective_*`` series), a one-shot ``collective_desync``
        event on first divergence, and the goodput ledger's straggler
        share.  ``per_rank_views`` overrides the gather (tests, virtual
        ranks)."""
        mon = self.collective_monitor
        if mon is None:
            return None
        from deepspeed_tpu_torch.telemetry import collective_monitor as cm
        view = mon.window_view()
        views = per_rank_views
        if views is None:
            views = self._gather_collective_views(view)
        health = cm.fold_windows(views, new_after=self._collective_fed_seq)
        last = (health.get("skew") or {}).get("last_seq", 0)
        if last > self._collective_fed_seq:
            self._collective_fed_seq = last
        self.emit(events.COLLECTIVE_WINDOW, view, step=step)
        self.emit(events.COLLECTIVE_HEALTH, health, step=step)
        desync = health.get("desync") or {}
        if desync.get("detected") and mon.desync_count == 0:
            mon.note_desync(desync)
            logger.error(
                "collective desync detected at seq=%s between ranks %s: %s"
                % (desync.get("first_seq"), desync.get("ranks"),
                   desync.get("fingerprints")))
            self.emit(events.COLLECTIVE_DESYNC, dict(desync), step=step)
        if self.ledger is not None:
            skew_s = sum(float(s.get("skew_ms", 0.0))
                         for s in health.get("skew_samples") or []) / 1e3
            self.ledger.note_straggler_share(skew_s)
        self._last_collective_health = health
        return health

    def collective_status(self) -> Optional[Dict[str, Any]]:
        """``/collectives`` endpoint body: the last fold verdict plus this
        rank's newest ring records."""
        mon = self.collective_monitor
        if mon is None:
            return None
        out = {
            "rank": mon.rank,
            "seq": mon.seq,
            "desync_count": mon.desync_count,
            "health": self._last_collective_health,
            "records": mon.last_records(32),
        }
        if mon.last_desync is not None:
            out["last_desync"] = mon.last_desync
        return out

    def health_check(self) -> Dict[str, Any]:
        """`/healthz` contribution: last-step / last-flush ages.  Always
        ``ok`` on its own (step cadence is workload-defined) — the
        watchdog check is what flips unhealthy on a stall."""
        now = time.monotonic()
        age = None
        if self._last_step_mono is not None:
            age = round(now - self._last_step_mono, 3)
        return {"ok": True, "last_step_age_s": age,
                "last_flush_age_s": round(now - self._last_flush_mono, 3),
                "pending_records": len(self._pending)}

    def close(self):
        if self.closed:
            return
        if self.collective_monitor is not None \
                and self.collective_monitor.seq:
            # final fold: short runs that never hit the snapshot cadence
            # still leave their window + health verdict in the JSONL
            try:
                self.collective_fold()
            except Exception as e:
                logger.warning(f"final collective fold failed: {e}")
        if self.ledger is not None and not self._goodput_final:
            # final cumulative snapshot: the same dict becomes the last
            # `goodput` record in the JSONL AND the EFFICIENCY.json body,
            # so the offline fold and the artifact agree exactly
            self._goodput_final = True
            try:
                snap = self.ledger.snapshot()
                self.emit(events.GOODPUT, snap)
                if self.efficiency_json_path:
                    self.ledger.write_efficiency_json(
                        self.efficiency_json_path, snap=snap)
            except Exception as e:
                logger.warning(f"goodput finalization failed: {e}")
        self.flush()
        if self._pending:        # SLO transition events from the final flush
            self.flush()
        if self.obs_server is not None:
            try:
                self.obs_server.stop()
            except Exception:
                pass
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass
        self.closed = True


# --------------------------------------------------------------------------- #
# A hub an engine builds from a config dict, and so owns
# --------------------------------------------------------------------------- #
class OwnedTelemetry:
    """The hub, and the tracer, that an engine built from a ``telemetry``
    config dict: nothing else holds them, so the engine's ``close()``
    calls :meth:`close`, which closes the hub (final flush, ops-server
    shutdown) and exports the tracer to ``trace_dir``."""

    def __init__(self, hub: "TelemetryHub", tracer=None, trace_dir: str = ""):
        self.hub, self.tracer, self.trace_dir = hub, tracer, trace_dir

    def close(self):
        try:
            self.hub.close()
        except Exception as e:
            logger.warning(f"telemetry close failed: {e}")
        if self.tracer is not None:
            from deepspeed_tpu_torch.telemetry.tracing import export_rank_trace
            export_rank_trace(self.tracer, self.trace_dir)
            self.tracer.close()


def telemetry_from_arg(telemetry, tracer=None, device=None):
    """An engine's ``telemetry=`` and ``tracer=`` arguments resolved:
    ``(hub, tracer, owned)``.  A hub (or None) is used as it is, and
    ``owned`` is None.  A ``telemetry`` config dict
    (``DeepSpeedTelemetryConfig``'s keys) builds a hub on ``device`` and,
    with ``tracing: true`` and no ``tracer``, a tracer; ``owned`` is the
    :class:`OwnedTelemetry` the engine closes (None when the dict is not
    ``enabled``)."""
    if not isinstance(telemetry, dict):
        return telemetry, tracer, None
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.config import DeepSpeedTelemetryConfig
    from deepspeed_tpu_torch.telemetry.tracing import Tracer
    tcfg = DeepSpeedTelemetryConfig(**telemetry)
    if not tcfg.enabled:
        return None, tracer, None
    hub = TelemetryHub.from_config(tcfg, device=device)
    owned = OwnedTelemetry(hub)
    if tcfg.tracing and tracer is None:
        tracer = owned.tracer = Tracer(rank=comm.get_rank(), capacity=tcfg.trace_buffer_size)
        owned.trace_dir = tcfg.trace_dir
    return hub, tracer, owned
