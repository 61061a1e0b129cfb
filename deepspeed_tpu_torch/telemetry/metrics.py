"""Live metrics plane: thread-safe registry, drain-path sink, cross-rank fold
(counterpart of ``deepspeed_tpu/telemetry/metrics.py``; the registry, the
sink and the Prometheus text are the JAX package's, line for line).

The registry is the in-process state behind the ops server's ``/metrics``
page and the SLO monitor.  Three metric families:

* :class:`Counter` — monotone float, ``inc()``.
* :class:`Gauge` — last-write-wins float, ``set()``; or a callable
  evaluated lazily at snapshot time (e.g. ``watchdog_heartbeat_age_s``).
* :class:`Histogram` — fixed-bucket counts with p50/p95/p99 estimation
  (:func:`~deepspeed_tpu_torch.telemetry.stats.quantile_from_buckets`).

Zero-sync discipline: ``inc`` / ``set`` / ``observe`` are hot-path
functions — callers hand them host
scalars (wall-clock deltas, drained telemetry values, store statistics);
nothing in here may force a device value.  Each update is one lock
acquire + one float add, cheap enough for per-request serving paths.

Cross-rank aggregation: :func:`pack_snapshot` flattens a snapshot into a
schema + float vector; :func:`fold_packed_over_group` reduces each rank's
vector over the ``torch.distributed`` process group of ``comm/`` (one
all-reduce for the sums of counters, gauges and histograms, one each for
the gauges' min and max), where the JAX package runs psum / pmin / pmax
under ``shard_map``; :func:`fold_packed` is the same fold of stacked
vectors in one process; and :func:`unpack_folded` rebuilds the pod-level
snapshot — equal to the host-side :func:`merge_snapshots` fold of the same
per-rank snapshots (histogram merge is vector addition, hence
associative).  The vectors are float64, so counts and byte counters stay
exact below 2**53.  At world size 1 the fold is the local snapshot's merge,
with no collective.
"""

import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.telemetry import collective_monitor as _cm
from deepspeed_tpu_torch.telemetry import stats as _stats

DEFAULT_MS_BUCKETS = _stats.DEFAULT_MS_BUCKETS

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_key(name: str, labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


# --------------------------------------------------------------------------- #
# Metric primitives
# --------------------------------------------------------------------------- #
class Counter:
    """Monotone counter.  ``inc`` is the zero-sync hot path."""

    __slots__ = ("name", "labels", "help", "_value", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 help: str = ""):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins gauge, or a lazy callable sampled at snapshot time.
    ``set`` is the zero-sync hot path."""

    __slots__ = ("name", "labels", "help", "_value", "_fn", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 help: str = "", fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return 0.0
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram; bucket ``i`` counts observations ≤
    ``bounds[i]``, plus one +Inf overflow bucket.  ``observe`` is the
    zero-sync hot path."""

    __slots__ = ("name", "labels", "help", "bounds", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 help: str = "", bounds: Sequence[float] = DEFAULT_MS_BUCKETS):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self.bounds = tuple(sorted(set(b * 1.0 for b in bounds)))
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value):
        i = _stats.bucket_index(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self._counts)
        return _stats.quantile_from_buckets(self.bounds, counts, q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
class MetricsRegistry:
    """Get-or-create metric store with a consistent snapshot view.

    Creation takes the registry lock; updates take only the metric's own
    lock, so concurrent writers never contend with the scraper beyond a
    single value read.  Instrumentation sites should cache the returned
    metric object rather than re-looking it up per event.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # pod-level merged view, refreshed by the periodic cross-rank fold
        self.pod_snapshot: Optional[Dict[str, Any]] = None
        self.pod_snapshot_unix: Optional[float] = None

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        key = _metric_key(name, labels)
        with self._lock:
            m = self._counters.get(key)
            if m is None:
                m = self._counters[key] = Counter(name, labels, help)
            return m

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "", fn: Optional[Callable[[], float]] = None) -> Gauge:
        key = _metric_key(name, labels)
        with self._lock:
            m = self._gauges.get(key)
            if m is None:
                m = self._gauges[key] = Gauge(name, labels, help, fn=fn)
            elif fn is not None:
                m._fn = fn
            return m

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "",
                  bounds: Sequence[float] = DEFAULT_MS_BUCKETS) -> Histogram:
        key = _metric_key(name, labels)
        with self._lock:
            m = self._histograms.get(key)
            if m is None:
                m = self._histograms[key] = Histogram(name, labels, help,
                                                      bounds=bounds)
            return m

    # -- read side -------------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        """Consistent host-value view of every metric (lazy gauges are
        sampled here)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        snap: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, c in counters.items():
            snap["counters"][key] = {"name": c.name, "labels": c.labels,
                                     "value": c.value}
        for key, g in gauges.items():
            snap["gauges"][key] = {"name": g.name, "labels": g.labels,
                                   "value": g.value}
        for key, h in hists.items():
            with h._lock:
                counts = list(h._counts)
                hsum = h._sum
                hcount = h._count
            snap["histograms"][key] = {
                "name": h.name, "labels": h.labels,
                "bounds": list(h.bounds), "counts": counts,
                "sum": hsum, "count": hcount,
            }
        return snap


# --------------------------------------------------------------------------- #
# Snapshot algebra (host side)
# --------------------------------------------------------------------------- #
def merge_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Host-side cross-rank fold — the reference the device fold must
    match: counters sum, gauges collapse to min/max/mean, histograms
    merge by bucket-count addition."""
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for key, c in (snap.get("counters") or {}).items():
            e = out["counters"].setdefault(
                key, {"name": c["name"], "labels": dict(c["labels"]),
                      "value": 0.0})
            e["value"] += float(c["value"])
        for key, g in (snap.get("gauges") or {}).items():
            v = float(g["value"])
            e = out["gauges"].get(key)
            if e is None:
                out["gauges"][key] = {"name": g["name"],
                                      "labels": dict(g["labels"]),
                                      "min": v, "max": v, "sum": v, "n": 1}
            else:
                e["min"] = min(e["min"], v)
                e["max"] = max(e["max"], v)
                e["sum"] += v
                e["n"] += 1
        for key, h in (snap.get("histograms") or {}).items():
            e = out["histograms"].get(key)
            if e is None:
                out["histograms"][key] = {
                    "name": h["name"], "labels": dict(h["labels"]),
                    "bounds": list(h["bounds"]), "counts": list(h["counts"]),
                    "sum": float(h["sum"]), "count": int(h["count"])}
            else:
                if list(e["bounds"]) != list(h["bounds"]):
                    raise ValueError(
                        f"histogram {key}: bucket bounds differ across ranks")
                e["counts"] = _stats.merge_bucket_counts(e["counts"],
                                                         h["counts"])
                e["sum"] += float(h["sum"])
                e["count"] += int(h["count"])
    for e in out["gauges"].values():
        e["mean"] = e["sum"] / e["n"]
    return out


def pack_snapshot(snapshot: Dict[str, Any]):
    """Flatten a snapshot into ``(schema, vector)`` for the device fold.

    Vector layout: ``[counter values | gauge values | histogram cells]``
    where each histogram contributes ``counts + [sum, count]``.  The
    schema (key order + histogram shapes) must be identical on every
    rank — it is derived from sorted metric keys, so ranks running the
    same instrumentation agree by construction.
    """
    schema = {
        "counters": sorted(snapshot.get("counters") or {}),
        "gauges": sorted(snapshot.get("gauges") or {}),
        "histograms": [
            (key, list((snapshot["histograms"][key])["bounds"]))
            for key in sorted(snapshot.get("histograms") or {})],
        "meta": {
            key: {"name": ent["name"], "labels": dict(ent["labels"])}
            for section in ("counters", "gauges", "histograms")
            for key, ent in (snapshot.get(section) or {}).items()},
    }
    vec: List[float] = []
    for key in schema["counters"]:
        vec.append(float(snapshot["counters"][key]["value"]))
    for key in schema["gauges"]:
        vec.append(float(snapshot["gauges"][key]["value"]))
    for key, bounds in schema["histograms"]:
        h = snapshot["histograms"][key]
        vec.extend(float(c) for c in h["counts"])
        vec.append(float(h["sum"]))
        vec.append(float(h["count"]))
    return schema, vec


def fold_packed(vectors: Sequence[Sequence[float]], n_counters: int,
                n_gauges: int) -> List[float]:
    """Fold stacked per-rank vectors (``[R, N]``, one row per rank) in this
    process into the layout :func:`unpack_folded` reads: ``[counter sums |
    gauge mins | gauge maxs | gauge sums | histogram sums]``."""
    import torch
    stacked = torch.as_tensor(vectors, dtype=torch.float64)
    if stacked.ndim != 2 or stacked.shape[0] == 0:
        raise ValueError("fold needs a non-empty [ranks, N] stack of vectors")
    nc, ng = int(n_counters), int(n_gauges)
    summed = stacked.sum(dim=0)
    gauges = stacked[:, nc:nc + ng]
    return torch.cat([summed[:nc], gauges.amin(dim=0), gauges.amax(dim=0),
                      summed[nc:nc + ng], summed[nc + ng:]]).tolist()


def _group_device():
    """The device a collective of the process group runs on: the current
    CUDA device under NCCL, else the CPU."""
    import torch
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check_same_schema(schema_key: str):
    """Raise on every rank unless every rank packed the same schema (a
    vector of another length would hang the all-reduce)."""
    import zlib

    import torch
    import torch.distributed as dist
    crc = float(zlib.crc32(schema_key.encode("utf-8")))
    t = torch.tensor([crc, -crc], dtype=torch.float64, device=_group_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if t[0].item() != -t[1].item():
        raise ValueError("rank snapshots disagree on metric schema")


def fold_packed_over_group(vector: Sequence[float], n_counters: int,
                           n_gauges: int) -> List[float]:
    """Reduce this rank's packed vector with every other rank's over the
    ``torch.distributed`` process group: the sum of the whole vector, the
    min and the max of its gauge part, laid out as :func:`fold_packed`
    lays them out.  Every rank gets the folded vector."""
    import torch
    import torch.distributed as dist
    nc, ng = int(n_counters), int(n_gauges)
    v = torch.as_tensor(list(vector), dtype=torch.float64, device=_group_device())
    summed = v.clone()
    mins = v[nc:nc + ng].clone()
    maxs = v[nc:nc + ng].clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM)
    dist.all_reduce(mins, op=dist.ReduceOp.MIN)
    dist.all_reduce(maxs, op=dist.ReduceOp.MAX)
    return torch.cat([summed[:nc], mins, maxs, summed[nc:nc + ng],
                      summed[nc + ng:]]).cpu().tolist()


def unpack_folded(schema: Dict[str, Any], folded: Sequence[float],
                  n_ranks: int) -> Dict[str, Any]:
    """Rebuild a merged snapshot (same shape as :func:`merge_snapshots`
    output) from the device-folded vector."""
    meta = schema.get("meta") or {}

    def _ent(key):
        m = meta.get(key) or {"name": key, "labels": {}}
        return {"name": m["name"], "labels": dict(m["labels"])}

    folded = [float(v) for v in folded]
    nc = len(schema["counters"])
    ng = len(schema["gauges"])
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    for i, key in enumerate(schema["counters"]):
        out["counters"][key] = {**_ent(key), "value": folded[i]}
    mins = folded[nc:nc + ng]
    maxs = folded[nc + ng:nc + 2 * ng]
    sums = folded[nc + 2 * ng:nc + 3 * ng]
    for i, key in enumerate(schema["gauges"]):
        out["gauges"][key] = {**_ent(key), "min": mins[i], "max": maxs[i],
                              "sum": sums[i], "n": n_ranks,
                              "mean": sums[i] / max(1, n_ranks)}
    pos = nc + 3 * ng
    for key, bounds in schema["histograms"]:
        ncells = len(bounds) + 1
        counts = [int(round(v)) for v in folded[pos:pos + ncells]]
        pos += ncells
        hsum = folded[pos]
        hcount = int(round(folded[pos + 1]))
        pos += 2
        out["histograms"][key] = {**_ent(key), "bounds": list(bounds),
                                  "counts": counts, "sum": hsum,
                                  "count": hcount}
    return out


def snapshot_from_vector(schema: Dict[str, Any],
                         vec: Sequence[float]) -> Dict[str, Any]:
    """Inverse of :func:`pack_snapshot` for one rank's vector — rebuilds
    a plain (un-merged) snapshot so gathered rank vectors can be re-merged
    host-side."""
    meta = schema.get("meta") or {}

    def _ent(key):
        m = meta.get(key) or {"name": key, "labels": {}}
        return {"name": m["name"], "labels": dict(m["labels"])}

    vec = [float(v) for v in vec]
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    pos = 0
    for key in schema["counters"]:
        out["counters"][key] = {**_ent(key), "value": vec[pos]}
        pos += 1
    for key in schema["gauges"]:
        out["gauges"][key] = {**_ent(key), "value": vec[pos]}
        pos += 1
    for key, bounds in schema["histograms"]:
        ncells = len(bounds) + 1
        counts = [int(round(v)) for v in vec[pos:pos + ncells]]
        pos += ncells
        out["histograms"][key] = {**_ent(key), "bounds": list(bounds),
                                  "counts": counts, "sum": vec[pos],
                                  "count": int(round(vec[pos + 1]))}
        pos += 2
    return out


def _world_size() -> int:
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
    except Exception:
        pass
    return 1


def cross_rank_snapshot(registry: MetricsRegistry,
                        per_rank_snapshots: Optional[Sequence[Dict]] = None
                        ) -> Dict[str, Any]:
    """Produce the pod-level merged snapshot and cache it on the registry.

    ``per_rank_snapshots`` (tests / offline replay) folds explicit rank
    snapshots in this process (:func:`fold_packed`); otherwise, with a
    process group of more than one rank, every rank's packed registry is
    folded over the group (:func:`fold_packed_over_group`: every rank must
    call this at the same point), and at world size 1 the result is the
    local snapshot's merge, with no collective."""
    if per_rank_snapshots:
        snaps = list(per_rank_snapshots)
        schema, _ = pack_snapshot(snaps[0])
        vectors = []
        for s in snaps:
            s_schema, vec = pack_snapshot(s)
            if (s_schema["counters"] != schema["counters"]
                    or s_schema["gauges"] != schema["gauges"]
                    or s_schema["histograms"] != schema["histograms"]):
                raise ValueError("rank snapshots disagree on metric schema")
            vectors.append(vec)
        folded = fold_packed(vectors, len(schema["counters"]),
                             len(schema["gauges"]))
        merged = unpack_folded(schema, folded, len(snaps))
    else:
        snap = registry.snapshot()
        world = _world_size()
        if world > 1:
            schema, vec = pack_snapshot(snap)
            _check_same_schema(json.dumps(
                [schema["counters"], schema["gauges"], schema["histograms"]]))
            folded = fold_packed_over_group(vec, len(schema["counters"]),
                                            len(schema["gauges"]))
            merged = unpack_folded(schema, folded, world)
        else:
            merged = merge_snapshots([snap])
    registry.pod_snapshot = merged
    registry.pod_snapshot_unix = time.time()
    return merged


# --------------------------------------------------------------------------- #
# Prometheus text exposition
# --------------------------------------------------------------------------- #
def _prom_name(prefix: str, name: str) -> str:
    return prefix + _NAME_SANITIZE.sub("_", name)


def _prom_labels(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        f'{k}="{str(v)}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


def render_prometheus(snapshot: Dict[str, Any], prefix: str = "dstpu_",
                      merged: bool = False) -> str:
    """Prometheus text-exposition (v0.0.4) rendering of a snapshot.

    ``merged=True`` renders a :func:`merge_snapshots`-shaped pod snapshot
    (gauges carry min/max/mean as an ``agg`` label)."""
    lines: List[str] = []
    typed = set()

    def _type(pname, kind):
        if pname not in typed:
            lines.append(f"# TYPE {pname} {kind}")
            typed.add(pname)

    for key in sorted(snapshot.get("counters") or {}):
        c = snapshot["counters"][key]
        pname = _prom_name(prefix, c["name"])
        _type(pname, "counter")
        lines.append(f"{pname}{_prom_labels(c['labels'])} {c['value']:g}")
    for key in sorted(snapshot.get("gauges") or {}):
        g = snapshot["gauges"][key]
        pname = _prom_name(prefix, g["name"])
        _type(pname, "gauge")
        if merged:
            for agg in ("min", "max", "mean"):
                lines.append(
                    f"{pname}{_prom_labels(g['labels'], {'agg': agg})} "
                    f"{g[agg]:g}")
        else:
            lines.append(f"{pname}{_prom_labels(g['labels'])} {g['value']:g}")
    for key in sorted(snapshot.get("histograms") or {}):
        h = snapshot["histograms"][key]
        pname = _prom_name(prefix, h["name"])
        _type(pname, "histogram")
        cum = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            cum += int(count)
            lines.append(
                f"{pname}_bucket{_prom_labels(h['labels'], {'le': bound})} "
                f"{cum}")
        cum += int(h["counts"][len(h["bounds"])])
        lines.append(
            f"{pname}_bucket{_prom_labels(h['labels'], {'le': '+Inf'})} {cum}")
        lines.append(f"{pname}_sum{_prom_labels(h['labels'])} {h['sum']:g}")
        lines.append(f"{pname}_count{_prom_labels(h['labels'])} {cum}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# Drain-path sink: telemetry records → registry
# --------------------------------------------------------------------------- #
class MetricsSink:
    """TelemetrySink fed from the hub's windowed drain — every record
    arriving here already holds host values (the hub drained the device
    once for the whole window), so the updates below are pure host math.

    Maps the established event kinds onto the registry: train ``step``
    records feed the step-time histogram and loss/lr gauges; serving
    request/step/preempt/restage records feed the TTFT and latency
    histograms, arena/tier occupancy gauges and stall counters; offload
    ``offload_staged`` deltas feed ring-hit and byte counters; stability
    and comm summaries feed anomaly/rollback counters and per-op wire
    bytes.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        r = registry
        self._steps = r.counter("train_steps_total")
        self._step_ms = r.histogram("train_step_time_ms")
        self._loss = r.gauge("train_loss")
        self._lr = r.gauge("train_lr")
        self._grad_norm = r.gauge("train_grad_norm")
        self._samples = r.gauge("train_samples_per_sec")
        self._comm_bytes = r.counter("train_comm_bytes_total")
        self._peak = r.gauge("device_peak_bytes")
        self._anomalies = r.counter("stability_anomalies_total")
        self._rollbacks = r.counter("stability_rollbacks_total")
        self._backoffs = r.counter("stability_lr_backoffs_total")
        self._quarantined = r.counter("stability_batches_quarantined_total")
        self._ttft = r.histogram("serve_ttft_ms")
        self._latency = r.histogram("serve_latency_ms")
        self._submitted = r.counter("serve_submitted_total")
        self._finished = r.counter("serve_finished_total")
        self._new_tokens = r.counter("serve_new_tokens_total")
        self._preempts = r.counter("serve_preemptions_total")
        self._spills = r.counter("kv_spills_total")
        self._restage_ok = r.counter("kv_restages_total")
        self._restage_fail = r.counter("kv_restage_failures_total")
        self._restage_wait = r.histogram("kv_restage_wait_ms")
        self._prefix_hits = r.counter("prefix_hits_total")

    def write(self, records):
        for rec in records:
            kind = rec.get("kind")
            handler = _SINK_HANDLERS.get(kind)
            if handler is not None:
                try:
                    handler(self, rec)
                except (TypeError, ValueError, KeyError):
                    pass    # malformed record: never poison the drain

    def close(self):
        ...

    # -- per-kind handlers (host values only) ------------------------------ #
    def _on_step(self, rec):
        self._steps.inc()
        if isinstance(rec.get("step_time_ms"), (int, float)):
            self._step_ms.observe(rec["step_time_ms"])
        for gauge, field in ((self._loss, "loss"), (self._lr, "lr"),
                             (self._grad_norm, "grad_norm"),
                             (self._samples, "samples_per_sec"),
                             (self._peak, "device_peak_bytes")):
            v = rec.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                gauge.set(v)
        cb = rec.get("comm_bytes")
        if isinstance(cb, (int, float)) and cb > 0:
            self._comm_bytes.inc(cb)

    def _on_serve_request(self, rec):
        if rec.get("event") == "submitted":
            self._submitted.inc()
        elif rec.get("event") == "finished":
            self._finished.inc()
            self._new_tokens.inc(int(rec.get("new_tokens", 0)))
            if isinstance(rec.get("ttft_ms"), (int, float)):
                self._ttft.observe(rec["ttft_ms"])
            if isinstance(rec.get("latency_ms"), (int, float)):
                self._latency.observe(rec["latency_ms"])

    SERVE_STEP_GAUGES = ("queue_depth", "active", "blocks_in_use",
                         "kv_host_bytes", "kv_nvme_bytes", "elapsed_ms")

    def _on_serve_step(self, rec):
        r = self.registry
        for field in self.SERVE_STEP_GAUGES:
            v = rec.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                r.gauge(f"serve_{field}").set(v)
        lookups = rec.get("prefix_lookups")
        if isinstance(lookups, (int, float)) and lookups:
            r.gauge("prefix_hit_rate").set(
                int(rec.get("prefix_hits", 0)) / int(lookups))

    def _on_serve_preempt(self, rec):
        self._preempts.inc()

    def _on_serve_shed(self, rec):
        if rec.get("event") == "level":
            self.registry.gauge("serve_shed_level").set(
                int(rec.get("level", 0)))
        else:
            self.registry.counter(
                "serve_shed_total",
                {"slo": str(rec.get("slo", "unknown"))}).inc()

    def _on_serve_expired(self, rec):
        self.registry.counter(
            "serve_expired_total",
            {"slo": str(rec.get("slo", "unknown"))}).inc()

    def _on_serve_incident(self, rec):
        if rec.get("event") != "recovered":
            return
        self.registry.counter("serve_incidents_total").inc()
        if isinstance(rec.get("recovery_s"), (int, float)):
            self.registry.histogram("serve_incident_recovery_s").observe(
                rec["recovery_s"])

    def _on_kv_spill(self, rec):
        self._spills.inc()
        tier = str(rec.get("tier", "unknown"))
        self.registry.counter("kv_spill_bytes_total",
                              {"tier": tier}).inc(int(rec.get("bytes", 0)))

    def _on_kv_restage(self, rec):
        if rec.get("ok"):
            self._restage_ok.inc()
            if isinstance(rec.get("wait_ms"), (int, float)):
                self._restage_wait.observe(rec["wait_ms"])
        else:
            self._restage_fail.inc()

    def _on_prefix_hit(self, rec):
        self._prefix_hits.inc()

    OFFLOAD_FIELDS = (("bytes_written", "offload_bytes_written_total"),
                      ("bytes_read", "offload_bytes_read_total"),
                      ("ring_hits", "offload_ring_hits_total"),
                      ("ring_misses", "offload_ring_misses_total"),
                      ("wait_ms", "offload_wait_ms_total"))

    def _on_offload_staged(self, rec):
        # records carry per-store DELTA fields `{store}_{field}` plus the
        # aggregate ring_hits/ring_misses/wait_ms keys
        r = self.registry
        stores = set()
        for key in rec:
            for field, _ in self.OFFLOAD_FIELDS:
                if key.endswith(f"_{field}"):
                    stores.add(key[:-(len(field) + 1)])
        for store in stores:
            for field, metric in self.OFFLOAD_FIELDS:
                v = rec.get(f"{store}_{field}")
                if isinstance(v, (int, float)) and not isinstance(v, bool) \
                        and v > 0:
                    r.counter(metric, {"store": store}).inc(v)
        hits = rec.get("ring_hits")
        misses = rec.get("ring_misses")
        if isinstance(hits, (int, float)) and isinstance(misses, (int, float)) \
                and (hits or misses):
            r.gauge("offload_ring_hit_rate").set(hits / (hits + misses))

    def _on_offload_wait(self, rec):
        # aggregate stall counter — the SLO `offload_stall_frac` numerator
        if isinstance(rec.get("wait_ms"), (int, float)):
            self.registry.counter("offload_stall_ms_total").inc(rec["wait_ms"])

    def _on_anomaly(self, rec):
        self._anomalies.inc()

    def _on_auto_rollback(self, rec):
        self._rollbacks.inc()

    def _on_lr_backoff(self, rec):
        self._backoffs.inc()

    def _on_batch_quarantined(self, rec):
        self._quarantined.inc()

    def _on_comm_summary(self, rec):
        # the CommsLogger fold is CUMULATIVE, so it lands on gauges (the
        # per-op `comm_bytes_total` counters are fed live, per staged op,
        # by the comm facade's registry hook); the trimmed-mean bucket
        # latencies feed the collective-latency histogram
        r = self.registry
        ops = rec.get("ops") or {}
        if isinstance(ops, dict):
            for op, ent in ops.items():
                if not isinstance(ent, dict):
                    continue
                tb = ent.get("total_bytes")
                if isinstance(tb, (int, float)):
                    r.gauge("comm_total_bytes", {"op": str(op)}).set(tb)
                cr = ent.get("compression_ratio")
                if isinstance(cr, (int, float)) and cr > 0:
                    r.gauge("comm_compression_ratio",
                            {"op": str(op)}).set(cr)
                for b in ent.get("buckets") or []:
                    lat = b.get("latency_ms") if isinstance(b, dict) else None
                    if isinstance(lat, (int, float)):
                        r.histogram("comm_collective_latency_ms").observe(lat)
        total = rec.get("total_bytes")
        logical = rec.get("total_logical_bytes")
        if isinstance(total, (int, float)) and total > 0 \
                and isinstance(logical, (int, float)) and logical > 0:
            r.gauge("comm_compression_ratio",
                    {"op": "all"}).set(logical / total)

    def _on_collective_health(self, rec):
        # the cross-rank fold verdict: incremental skew samples → the
        # `collective_skew_ms` histogram, straggler scores → gauges — the
        # SINGLE feed path for dstpu_collective_* series, so the live
        # registry and offline replay agree by construction
        _cm.feed_registry(self.registry, rec)

    def _on_collective_desync(self, rec):
        self.registry.counter("collective_desync_total").inc()
        desync = rec.get("desync") or rec
        if isinstance(desync.get("first_seq"), (int, float)):
            self.registry.gauge("collective_desync_first_seq").set(
                float(desync["first_seq"]))

    def _on_slo_burn(self, rec):
        self.registry.counter(
            "slo_burn_total", {"rule": str(rec.get("rule", "unknown")),
                               "severity": str(rec.get("severity", "fast"))}
        ).inc()

    def _on_downtime(self, rec):
        # elastic-agent restart gap: feeds the same category counter the
        # GoodputLedger mirrors, so the agent's /metrics carries it
        self.registry.counter(
            "goodput_seconds_total", {"category": "downtime"}
        ).inc(float(rec.get("downtime_s", 0.0)))
        self.registry.counter("goodput_downtime_events_total").inc()


_SINK_HANDLERS = {
    "step": MetricsSink._on_step,
    "serve_request": MetricsSink._on_serve_request,
    "serve_step": MetricsSink._on_serve_step,
    "serve_preempt": MetricsSink._on_serve_preempt,
    "serve_shed": MetricsSink._on_serve_shed,
    "serve_expired": MetricsSink._on_serve_expired,
    "serve_incident": MetricsSink._on_serve_incident,
    "kv_spill": MetricsSink._on_kv_spill,
    "kv_restage": MetricsSink._on_kv_restage,
    "prefix_hit": MetricsSink._on_prefix_hit,
    "offload_staged": MetricsSink._on_offload_staged,
    "offload_wait": MetricsSink._on_offload_wait,
    "anomaly": MetricsSink._on_anomaly,
    "auto_rollback": MetricsSink._on_auto_rollback,
    "lr_backoff": MetricsSink._on_lr_backoff,
    "batch_quarantined": MetricsSink._on_batch_quarantined,
    "comm_summary": MetricsSink._on_comm_summary,
    "collective_health": MetricsSink._on_collective_health,
    "collective_desync": MetricsSink._on_collective_desync,
    "slo_burn": MetricsSink._on_slo_burn,
    "downtime": MetricsSink._on_downtime,
}


def replay_jsonl(registry: MetricsRegistry, records) -> MetricsRegistry:
    """Feed already-loaded telemetry records through a MetricsSink —
    the offline path ``tools/obs_report.py`` uses so its registry view is
    bit-identical to what the live sink would have accumulated."""
    sink = MetricsSink(registry)
    sink.write(list(records))
    return registry


def dumps_snapshot(snapshot: Dict[str, Any]) -> str:
    return json.dumps(snapshot, indent=2, sort_keys=True)
