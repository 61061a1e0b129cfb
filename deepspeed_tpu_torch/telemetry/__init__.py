"""deepspeed_tpu_torch.telemetry — structured step events, JSONL sink, windowed
``torch.profiler`` capture, span tracing, the hang-watchdog flight recorder,
and the live observability plane (metrics registry, ops HTTP endpoints, SLO
burn-rate monitors): the counterpart of ``deepspeed_tpu/telemetry/``, with
its ``__all__``.  All of it is host code; the records, the Prometheus text,
the Chrome traces, the flight-recorder dumps and ``EFFICIENCY.json`` are the
JAX package's formats, so the repo's ``tools/`` read the port's files as
they are.  ``report.py`` is not ported (only JAX's ``tools/`` use it)."""

from deepspeed_tpu_torch.telemetry import events, stats
from deepspeed_tpu_torch.telemetry.events import (SCHEMA_VERSION,
                                            STEP_REQUIRED_FIELDS, make_record)
from deepspeed_tpu_torch.telemetry.flight_recorder import FlightRecorder, read_dump
from deepspeed_tpu_torch.telemetry.hub import (JsonlSink, MonitorSink,
                                         RingBufferSink, TelemetryHub,
                                         TelemetrySink)
from deepspeed_tpu_torch.telemetry.ledger import (CATEGORIES, GoodputLedger,
                                            fold_goodput)
from deepspeed_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                             MetricsRegistry, MetricsSink,
                                             cross_rank_snapshot,
                                             merge_snapshots,
                                             render_prometheus)
from deepspeed_tpu_torch.telemetry.obs_server import ObsServer, watchdog_health_check
from deepspeed_tpu_torch.telemetry.profiler import ProfilerWindow
from deepspeed_tpu_torch.telemetry.slo import (SLOMonitor, SLORule, default_rules,
                                         rules_from_config)
from deepspeed_tpu_torch.telemetry.tracing import (Tracer, get_global_tracer,
                                             maybe_span, set_global_tracer)
from deepspeed_tpu_torch.telemetry.watchdog import HangWatchdog

__all__ = [
    "events",
    "stats",
    "SCHEMA_VERSION",
    "STEP_REQUIRED_FIELDS",
    "make_record",
    "TelemetryHub",
    "TelemetrySink",
    "JsonlSink",
    "RingBufferSink",
    "MonitorSink",
    "ProfilerWindow",
    "Tracer",
    "set_global_tracer",
    "get_global_tracer",
    "maybe_span",
    "HangWatchdog",
    "FlightRecorder",
    "read_dump",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsSink",
    "merge_snapshots",
    "cross_rank_snapshot",
    "render_prometheus",
    "GoodputLedger",
    "CATEGORIES",
    "fold_goodput",
    "ObsServer",
    "watchdog_health_check",
    "SLORule",
    "SLOMonitor",
    "default_rules",
    "rules_from_config",
]
