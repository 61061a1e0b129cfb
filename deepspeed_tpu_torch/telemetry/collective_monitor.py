"""Collective health plane — per-collective records, cross-rank skew fold,
desync detection, straggler attribution (counterpart of
``deepspeed_tpu/telemetry/collective_monitor.py``; the records, the fold and
the ``collective_*`` JSONL records are the JAX package's).

Distributed runs fail in ways the step-level observability plane cannot
attribute: one rank arrives late at every all-reduce (a straggler), one
rank never arrives at all (a wedge), or — worst — ranks silently stage
*different* collective sequences and the program deadlocks or corrupts
data with nothing in the logs (the desync failure class The Big Send-off
calls out, arXiv:2504.18658).  This module gives every collective that
crosses the ``deepspeed_tpu_torch.comm`` facade an identity and a clock:

* **Record** — each staged collective gets a per-rank monotonic
  ``seq`` and a structure *fingerprint* (CRC-32 of op|axis|dtype|shape —
  deterministic across processes, unlike Python's salted ``hash``),
  appended to a bounded ring with ``time.monotonic_ns`` enter/exit
  stamps.  The hot path (:meth:`CollectiveMonitor.begin` /
  :meth:`~CollectiveMonitor.end`) is zero-sync by construction — it
  reads only host metadata (op name, group, dtype and shape), never a
  device value.  A collective called eagerly is bracketed on the host
  around its launch; one inside a captured CUDA graph is recorded once,
  when the graph is captured, as the JAX package records a collective
  once, when it is staged into a program.

* **Fold** — :func:`fold_windows` merges per-rank window views into one
  health verdict: per-collective skew (first-vs-last rank arrival at
  each common ``seq``) folded into fixed-bucket histograms (global and
  per-op), an exponentially-weighted per-rank straggler score naming the
  chronically-late rank, and **desync detection** — the first ``seq``
  where any two ranks staged structurally different collectives, with
  both fingerprints and the divergent ranks named in the verdict.

* Three equal fold paths (mirroring the metrics-plane
  ``pack_snapshot``/``fold_packed_over_group`` discipline): the host fold
  of in-memory views, the process-group path (each rank's
  :func:`pack_window` vector gathered over ``torch.distributed`` by
  :func:`gather_windows_over_group`, then the same host fold), and the
  offline path (:func:`fold_window_records` over the per-rank
  ``collective_window`` JSONL records the hub emits at
  ``snapshot_every`` cadence — what ``tools/collective_report.py``
  gates).

Time base: each monitor anchors ``time.monotonic_ns`` against
``time.time`` once at construction and expresses stamps as integer
*microseconds since the unix epoch* — ints survive JSON exactly, and
wall anchoring makes stamps from different processes comparable (same
discipline as ``tracing.py``'s ``clock_sync``).

Standard library only, except ``torch`` inside the process-group
gather.
"""

import threading
import time
import zlib
from collections import deque

SCHEMA_VERSION = 1

#: skew histogram bucket upper bounds (ms) — sub-millisecond resolution
#: at the bottom (NVLink-local skew) up to multi-second stragglers.
DEFAULT_SKEW_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 15000.0, 60000.0)

#: EW smoothing factor for the per-rank straggler score.
DEFAULT_EW_ALPHA = 0.2

#: floats per record row in the packed device vector (see pack_window).
_ROW_WIDTH = 8

from deepspeed_tpu_torch.telemetry import stats as _stats


def fingerprint_of(op, axis, dtype, shape):
    """Deterministic 32-bit structure fingerprint of one collective.

    CRC-32 over the canonical ``op|axis|dtype|shape`` string: identical
    across processes and runs (Python ``hash`` is salted per process, so
    it could never be compared across ranks), cheap enough for the
    staged hot path, and sensitive to every structural field — two ranks
    staging the same op over the same axis with different dtypes or
    shapes get different fingerprints, which is exactly the divergence
    the desync detector keys on.
    """
    key = "%s|%s|%s|%s" % (op, axis, dtype, tuple(shape))
    return zlib.crc32(key.encode("utf-8"))


class CollectiveMonitor:
    """Per-rank bounded ring of collective records.

    ``begin`` / ``end`` are the comm-facade hot path (one lock, one
    clock read, one deque append — and **no device access**: dtype and
    shape arrive as already-host metadata).  Everything else is
    fold/ops-plane code that runs at snapshot cadence or on demand.
    """

    def __init__(self, rank=0, capacity=2048, clock_ns=time.monotonic_ns):
        self.rank = int(rank)
        self.capacity = max(1, int(capacity))
        self._clock_ns = clock_ns
        self._ring = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        # wall anchor: monotonic stamps become epoch-comparable microseconds
        self._anchor_unix_us = int(time.time() * 1e6)
        self._anchor_mono_ns = clock_ns()
        self.desync_count = 0
        self.last_desync = None

    # ---- hot path (zero-sync: host metadata only) ----------------------- #

    def _now_us(self):
        return self._anchor_unix_us + (
            self._clock_ns() - self._anchor_mono_ns) // 1000

    def begin(self, op, axis, dtype, shape, nbytes):
        """Open one collective record: assign the next ``seq``, stamp the
        enter time, append to the ring.  Appending at *begin* (not end)
        is load-bearing: a collective that wedges and never exits is
        still in the ring when the flight recorder dumps it."""
        rec = {
            "seq": 0,                   # assigned under the lock below
            "op": op,
            "axis": "" if axis is None else str(axis),
            "dtype": str(dtype),
            "shape": shape,
            "bytes": nbytes,
            "fp": 0,
            "t_enter_us": self._now_us(),
            "t_exit_us": None,
        }
        rec["fp"] = fingerprint_of(rec["op"], rec["axis"], rec["dtype"],
                                   rec["shape"])
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        return rec

    def end(self, rec):
        """Stamp the exit time on an open record."""
        rec["t_exit_us"] = self._now_us()

    # ---- read side ------------------------------------------------------ #

    @property
    def seq(self):
        with self._lock:
            return self._seq

    def last_records(self, n=None):
        """Newest-last JSON-ready view of (up to) the last ``n`` records —
        the flight-recorder section payload."""
        with self._lock:
            recs = list(self._ring)
        if n is not None:
            recs = recs[-int(n):]
        return [_record_to_json(r) for r in recs]

    def window_view(self, max_records=None):
        """This rank's fold input: the current ring window as one
        JSON-ready view (the body of a ``collective_window`` telemetry
        record)."""
        return {
            "schema": SCHEMA_VERSION,
            "rank": self.rank,
            "seq": self.seq,
            "records": self.last_records(max_records),
        }

    # ---- desync bookkeeping (fed by the fold) --------------------------- #

    def note_desync(self, detail):
        """The cross-rank fold detected a fingerprint divergence; latch it
        so ``/healthz`` flips unhealthy and stays there."""
        self.desync_count += 1
        self.last_desync = dict(detail)

    def health_check(self):
        """``/healthz`` contribution: unhealthy once any desync has been
        detected (a desynced program is undefined behavior — there is no
        recovering to ``ok`` within the same incarnation)."""
        out = {"ok": self.desync_count == 0,
               "desync_count": self.desync_count,
               "seq": self.seq}
        if self.last_desync is not None:
            out["first_seq"] = self.last_desync.get("first_seq")
        return out

    def wedged_summary(self):
        """One-line 'what was the last collective' context string for the
        watchdog's stall log — names the op a wedge is stuck in."""
        with self._lock:
            rec = self._ring[-1] if self._ring else None
        if rec is None:
            return "no collectives recorded"
        state = "open" if rec["t_exit_us"] is None else "closed"
        return ("last collective seq=%d op=%s axis=%s dtype=%s shape=%s "
                "bytes=%d (%s)" % (rec["seq"], rec["op"], rec["axis"],
                                   rec["dtype"], tuple(rec["shape"]),
                                   rec["bytes"], state))


def _record_to_json(rec):
    out = dict(rec)
    out["shape"] = [int(d) for d in rec["shape"]]
    out["bytes"] = int(rec["bytes"])
    return out


# --------------------------------------------------------------------------- #
# Cross-rank fold (pure host math — shared by live hub, device parity path,
# and the offline report CLI)
# --------------------------------------------------------------------------- #

def _by_seq(view):
    """seq → record for one rank's view (later records win on repeats)."""
    return {int(r["seq"]): r for r in view.get("records", [])}


def fold_windows(views, skew_bounds=DEFAULT_SKEW_BUCKETS_MS,
                 ew_alpha=DEFAULT_EW_ALPHA, new_after=0):
    """Fold per-rank window views into one collective-health verdict.

    * **Desync**: walking ``seq`` ascending over every seq two or more
      ranks recorded, the first one where fingerprints differ is the
      divergence point; the verdict names it, the divergent ranks, and
      each rank's full fingerprint (op/axis/dtype/shape) — ranks that
      merely *miss* a seq (ring eviction, different window tails) are
      not desynced.
    * **Skew**: over seqs present on *all* ranks, first-vs-last arrival
      (enter stamps) in ms, folded into fixed-bucket histograms
      (global + per-op) with p50/p99 estimates.
    * **Straggler**: per-rank EW average of each rank's arrival offset
      from the earliest rank, walked in seq order; the max-score rank is
      the named straggler.
    * ``new_after``: skew samples with ``seq`` ≤ this are folded into
      the histograms but excluded from ``skew_samples`` — the
      incremental feed the live registry consumes without re-observing
      seqs from a previous fold of an overlapping window.
    """
    views = [v for v in views if v is not None]
    ranks = [int(v.get("rank", i)) for i, v in enumerate(views)]
    by_rank = {r: _by_seq(v) for r, v in zip(ranks, views)}
    n_ranks = len(by_rank)
    all_seqs = sorted({s for recs in by_rank.values() for s in recs})

    # -- desync: first seq where any two ranks disagree structurally ----- #
    desync = {"detected": False}
    for s in all_seqs:
        present = {r: recs[s] for r, recs in by_rank.items() if s in recs}
        if len(present) < 2:
            continue
        fps = {int(rec["fp"]) for rec in present.values()}
        if len(fps) > 1:
            desync = {
                "detected": True,
                "first_seq": s,
                "ranks": sorted(present),
                "fingerprints": {
                    str(r): {"fp": int(rec["fp"]), "op": rec["op"],
                             "axis": rec["axis"], "dtype": rec["dtype"],
                             "shape": [int(d) for d in rec["shape"]]}
                    for r, rec in sorted(present.items())},
            }
            break

    # -- skew + straggler over fully-common seqs -------------------------- #
    bounds = tuple(float(b) for b in skew_bounds)
    counts = [0] * (len(bounds) + 1)
    skew_sum = 0.0
    skew_max = 0.0
    per_op = {}
    samples = []
    scores = {r: 0.0 for r in by_rank}
    last_common = 0
    common = [s for s in all_seqs
              if all(s in recs for recs in by_rank.values())]
    if n_ranks >= 2:
        for s in common:
            enters = {r: int(recs[s]["t_enter_us"])
                      for r, recs in by_rank.items()}
            first = min(enters.values())
            skew_ms = (max(enters.values()) - first) / 1000.0
            counts[_stats.bucket_index(bounds, skew_ms)] += 1
            skew_sum += skew_ms
            skew_max = max(skew_max, skew_ms)
            op = by_rank[min(by_rank)][s]["op"]
            ent = per_op.setdefault(op, {"counts": [0] * (len(bounds) + 1),
                                         "sum_ms": 0.0, "count": 0})
            ent["counts"][_stats.bucket_index(bounds, skew_ms)] += 1
            ent["sum_ms"] += skew_ms
            ent["count"] += 1
            for r in scores:
                dt_ms = (enters[r] - first) / 1000.0
                scores[r] = (1.0 - ew_alpha) * scores[r] + ew_alpha * dt_ms
            if s > new_after:
                samples.append({"seq": s, "op": op,
                                "skew_ms": round(skew_ms, 6)})
            last_common = s

    n_skew = sum(counts)
    for op, ent in per_op.items():
        ent["p50_ms"] = _stats.quantile_from_buckets(bounds, ent["counts"],
                                                     0.50)
        ent["p99_ms"] = _stats.quantile_from_buckets(bounds, ent["counts"],
                                                     0.99)
    straggler_rank = None
    straggler_score = 0.0
    if n_ranks >= 2 and n_skew:
        straggler_rank = max(sorted(scores), key=lambda r: scores[r])
        straggler_score = scores[straggler_rank]

    return {
        "schema": SCHEMA_VERSION,
        "n_ranks": n_ranks,
        "ranks": sorted(by_rank),
        "seq_lo": all_seqs[0] if all_seqs else 0,
        "seq_hi": all_seqs[-1] if all_seqs else 0,
        "common_seqs": len(common),
        "skew": {
            "bounds": list(bounds),
            "counts": counts,
            "count": n_skew,
            "sum_ms": skew_sum,
            "max_ms": skew_max,
            "p50_ms": _stats.quantile_from_buckets(bounds, counts, 0.50),
            "p99_ms": _stats.quantile_from_buckets(bounds, counts, 0.99),
            "last_seq": last_common,
        },
        "per_op_skew": per_op,
        "straggler": {
            "rank": straggler_rank,
            "score_ms": round(straggler_score, 6),
            "scores_ms": {str(r): round(v, 6)
                          for r, v in sorted(scores.items())},
            "ew_alpha": ew_alpha,
        },
        "skew_samples": samples,
        "desync": desync,
    }


def fold_window_records(records, skew_bounds=DEFAULT_SKEW_BUCKETS_MS,
                        ew_alpha=DEFAULT_EW_ALPHA):
    """Offline fold: merge the ``collective_window`` records of a
    telemetry JSONL set (possibly many windows per rank — records merge
    per rank by seq, later windows win) and run :func:`fold_windows`.
    Returns ``None`` when the set carries no window records."""
    merged = {}
    for rec in records:
        if rec.get("kind") != "collective_window":
            continue
        rank = int(rec.get("rank", 0))
        dst = merged.setdefault(rank, {})
        for r in rec.get("records", []):
            dst[int(r["seq"])] = r
    if not merged:
        return None
    views = [{"schema": SCHEMA_VERSION, "rank": rank,
              "records": [dst[s] for s in sorted(dst)]}
             for rank, dst in sorted(merged.items())]
    return fold_windows(views, skew_bounds=skew_bounds, ew_alpha=ew_alpha)


# --------------------------------------------------------------------------- #
# Process-group fold path — packed vectors gathered over torch.distributed
# --------------------------------------------------------------------------- #
#
# Row layout per record (all values exact in float32):
#   [seq, fp_hi, fp_lo, dt_us_hi, dt_us_lo, bytes_hi, bytes_lo, exit_flag]
# fp (32-bit) splits 16/16; dt_us (enter - base, < 2**48 us) and bytes
# split 24/24 — every half stays under 2**24, the float32 exact-integer
# range.  Rows are padded with -1 up to ``width`` records per rank.

def pack_window(view, base_us, width):
    """→ (meta, vector): the fixed-width float row-matrix for one rank's
    view plus the host-side fingerprint dictionary (fp → structure) the
    unpack needs to restore record fields — same split as the metrics
    fold's schema/vector pair."""
    meta = {}
    vec = []
    recs = view.get("records", [])[-int(width):]
    for r in recs:
        fp = int(r["fp"])
        meta[str(fp)] = {"op": r["op"], "axis": r["axis"],
                         "dtype": r["dtype"],
                         "shape": [int(d) for d in r["shape"]]}
        dt = int(r["t_enter_us"]) - int(base_us)
        if not (0 <= dt < 1 << 48):
            raise ValueError(f"enter stamp out of pack range: dt_us={dt}")
        nbytes = min(int(r["bytes"]), (1 << 48) - 1)
        vec.extend([
            float(int(r["seq"])),
            float(fp >> 16), float(fp & 0xFFFF),
            float(dt >> 24), float(dt & 0xFFFFFF),
            float(nbytes >> 24), float(nbytes & 0xFFFFFF),
            1.0 if r.get("t_exit_us") is not None else 0.0,
        ])
    pad = int(width) - len(recs)
    vec.extend([-1.0] * (pad * _ROW_WIDTH))
    return meta, vec


def unpack_window(vector, meta, rank, base_us):
    """Inverse of :func:`pack_window` for one gathered row — rebuilds a
    fold-ready view (exit stamps collapse to a presence flag; the skew
    fold only reads enter stamps)."""
    records = []
    vec = [float(v) for v in vector]
    for i in range(0, len(vec), _ROW_WIDTH):
        row = vec[i:i + _ROW_WIDTH]
        if len(row) < _ROW_WIDTH or row[0] < 0:
            continue
        fp = (int(round(row[1])) << 16) | int(round(row[2]))
        dt = (int(round(row[3])) << 24) | int(round(row[4]))
        nbytes = (int(round(row[5])) << 24) | int(round(row[6]))
        m = meta.get(str(fp)) or {"op": "?", "axis": "", "dtype": "?",
                                  "shape": []}
        records.append({
            "seq": int(round(row[0])),
            "op": m["op"], "axis": m["axis"], "dtype": m["dtype"],
            "shape": list(m["shape"]),
            "bytes": nbytes,
            "fp": fp,
            "t_enter_us": int(base_us) + dt,
            "t_exit_us": 0 if row[7] > 0.5 else None,
        })
    return {"schema": SCHEMA_VERSION, "rank": int(rank), "records": records}


def gather_windows_over_group(view, width=None):
    """Every rank's window view, gathered over the ``torch.distributed``
    process group (every rank calls this at the same point with its own
    view): the enter-stamp base and the row width are agreed first (one
    min and one max all-reduce), each rank's :func:`pack_window` vector
    is gathered in one ``all_gather`` of float64 rows, the fingerprint
    dictionaries in one ``all_gather_object``, and the rows are unpacked
    back into fold-ready views in rank order — the views
    :func:`fold_windows` takes, equal to the ranks' own after a host
    round trip (exit stamps become a presence flag)."""
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    recs = view.get("records", [])
    if width is not None:
        recs = recs[-int(width):]
    enters = [int(r["t_enter_us"]) for r in recs]
    # base as min, width as max: one MIN all-reduce of (base, -width)
    agreed = torch.tensor([float(min(enters)) if enters else float(2 ** 62),
                           -float(len(recs))], dtype=torch.float64, device=device)
    dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
    base_us = int(agreed[0].item()) if agreed[0].item() < 2 ** 62 else 0
    width_all = max(1, int(-agreed[1].item()))
    meta, vec = pack_window(dict(view, records=recs), base_us, width_all)
    mine = torch.tensor(vec, dtype=torch.float64, device=device)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    metas = [None] * dist.get_world_size()
    dist.all_gather_object(metas, meta)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, int(view.get("rank", dist.get_rank())))
    return [unpack_window(rows[i].cpu().tolist(), metas[i], ranks[i], base_us)
            for i in range(len(rows))]


# --------------------------------------------------------------------------- #
# Registry feed (shared by the live MetricsSink handler and offline replay)
# --------------------------------------------------------------------------- #

def feed_registry(registry, health):
    """Publish one fold verdict onto a MetricsRegistry: incremental skew
    observations (``skew_samples`` only — the fold already deduplicates
    against the previous window via ``new_after``), straggler gauges, and
    the per-op staged counts.  The ``dstpu_collective_*`` Prometheus
    series render straight off these."""
    skew = health.get("skew") or {}
    bounds = tuple(skew.get("bounds") or DEFAULT_SKEW_BUCKETS_MS)
    hist = registry.histogram("collective_skew_ms", bounds=bounds,
                              help="first-vs-last rank arrival per "
                                   "collective seq")
    for s in health.get("skew_samples") or []:
        v = s.get("skew_ms")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            hist.observe(float(v))
            op = str(s.get("op", "?"))
            registry.histogram("collective_skew_ms", {"op": op},
                               bounds=bounds).observe(float(v))
    strag = health.get("straggler") or {}
    for rank, score in (strag.get("scores_ms") or {}).items():
        registry.gauge("collective_straggler_score_ms",
                       {"rank": str(rank)},
                       help="EW arrival-offset score per rank").set(
            float(score))
    if strag.get("rank") is not None:
        registry.gauge("collective_straggler_rank",
                       help="rank with the worst EW straggler score").set(
            float(strag["rank"]))
    registry.gauge("collective_common_seqs",
                   help="seqs present on every rank in the last fold").set(
        float(health.get("common_seqs", 0)))
    desync = health.get("desync") or {}
    if desync.get("detected"):
        registry.gauge("collective_desync_first_seq").set(
            float(desync.get("first_seq", 0)))
