"""Telemetry record schema (counterpart of
``deepspeed_tpu/telemetry/events.py``, copied as it is: the port writes
the JAX package's records).

Every record the :class:`~deepspeed_tpu_torch.telemetry.hub.TelemetryHub` emits is
a flat JSON-serializable dict with two reserved keys:

* ``kind`` — the record type (one of :data:`KINDS`);
* ``schema`` — the schema version (:data:`SCHEMA_VERSION`), stamped by the
  hub so a JSONL file is self-describing and ``tools/telemetry_report.py``
  can refuse files it does not understand.

``step`` records additionally guarantee :data:`STEP_REQUIRED_FIELDS` — the
contract the JSONL acceptance test and the report folder both rely on.
Values may be device tensors at emission time; the hub converts them to host
floats at drain boundaries (see the hub's windowed-drain discipline).
"""

from typing import Any, Dict

SCHEMA_VERSION = 1

# record kinds ------------------------------------------------------------- #
STEP = "step"                      # one optimizer step of a training engine
PIPE = "pipe"                      # pipeline schedule stats (bubble fraction)
INFERENCE = "inference_request"    # one generate()/forward() serving request
MOE = "moe_gauge"                  # expert-load / drop-fraction gauges
COMM_SUMMARY = "comm_summary"      # CommsLogger fold (op counts/bytes/bw)
FLOPS_BREAKDOWN = "flops_breakdown"  # one-shot per-module FLOPs cost table
WORKER_EXIT = "worker_exit"        # elastic-agent worker group exit/restart
CKPT_SAVED = "ckpt_saved"          # one durable (committed+verified) checkpoint
CKPT_RETRY = "ckpt_retry"          # transient storage error, save being retried
CKPT_ROLLBACK = "ckpt_rollback"    # corrupt/torn tag skipped at load
PREEMPTION = "preemption"          # preemption notice / final-checkpoint exit
ANOMALY = "anomaly"                # stability sentinel detection (cause code)
LR_BACKOFF = "lr_backoff"          # recovery ladder scaled the LR schedule
AUTO_ROLLBACK = "auto_rollback"    # ladder rolled back to a verified tag
BATCH_QUARANTINED = "batch_quarantined"  # fingerprint quarantined / skipped
EF_RESET = "ef_reset"              # compression error-feedback zeroed at load
SERVE_REQUEST = "serve_request"    # one completed ServingEngine request (TTFT)
SERVE_STEP = "serve_step"          # serving-loop gauges (queue depth, blocks)
SERVE_PREEMPT = "serve_preempt"    # SLO/arena preemption (blocks evicted)
SERVE_SHED = "serve_shed"          # admission-ladder rejection / rung change
SERVE_EXPIRED = "serve_expired"    # request deadline passed; cancelled
SERVE_INCIDENT = "serve_incident"  # wedged serve step -> in-process recovery
KV_SPILL = "kv_spill"              # preempted KV captured to host/NVMe tier
KV_RESTAGE = "kv_restage"          # spilled KV restored on re-admission
PREFIX_HIT = "prefix_hit"          # cached prompt blocks attached copy-free
PROGRAM_CACHE = "program_cache_evict"  # inference per-shape LRU cache eviction
OFFLOAD_STAGED = "offload_staged"  # per-step staging fold (bytes, ring hits)
OFFLOAD_WAIT = "offload_wait"      # blocking stall on a staged read/write
DOWNTIME = "downtime"              # elastic-agent worker_exit -> restart gap
GOODPUT = "goodput"                # cumulative GoodputLedger snapshot
COLLECTIVE_WINDOW = "collective_window"    # one rank's collective-ring window
COLLECTIVE_HEALTH = "collective_health"    # cross-rank skew/straggler fold
COLLECTIVE_DESYNC = "collective_desync"    # fingerprint divergence detected
SCHEMA = "schema"                  # JSONL header record (written by the sink)

KINDS = (STEP, PIPE, INFERENCE, MOE, COMM_SUMMARY, FLOPS_BREAKDOWN,
         WORKER_EXIT, CKPT_SAVED, CKPT_RETRY, CKPT_ROLLBACK, PREEMPTION,
         ANOMALY, LR_BACKOFF, AUTO_ROLLBACK, BATCH_QUARANTINED, EF_RESET,
         SERVE_REQUEST, SERVE_STEP, SERVE_PREEMPT, SERVE_SHED, SERVE_EXPIRED,
         SERVE_INCIDENT, KV_SPILL, KV_RESTAGE,
         PREFIX_HIT, PROGRAM_CACHE, OFFLOAD_STAGED, OFFLOAD_WAIT, DOWNTIME,
         GOODPUT, COLLECTIVE_WINDOW, COLLECTIVE_HEALTH, COLLECTIVE_DESYNC,
         SCHEMA)

# Every `step` record carries at least these keys once drained.
STEP_REQUIRED_FIELDS = (
    "step",
    "loss",
    "lr",
    "step_time_ms",
    "samples_per_sec",
    "comm_bytes",
    "device_peak_bytes",
)


def make_record(kind: str, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp ``kind``/``schema`` onto a payload (payload keys win nothing:
    the reserved keys are overwritten)."""
    rec = dict(payload)
    rec["kind"] = kind
    rec["schema"] = SCHEMA_VERSION
    return rec
