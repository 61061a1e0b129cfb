"""Shared statistics primitives for the observability plane (counterpart
of ``deepspeed_tpu/telemetry/stats.py``, copied as it is).

One home for the percentile / histogram / JSONL-loading math that used to
be copy-pasted across ``tools/serve_report.py``, ``tools/offload_audit.py``
and ``tools/stability_report.py``, now also backing the live
:class:`~deepspeed_tpu_torch.telemetry.metrics.MetricsRegistry`.

Standard library only, no intra-package imports, as in the JAX package,
whose report CLIs load their copy by file path.
"""

import bisect
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------- #
# Percentiles (exact, over sorted samples) — the offline-report estimator.
# --------------------------------------------------------------------------- #


def percentile(sorted_vals: Sequence[float], q: float):
    """Nearest-rank percentile over an already-sorted sample list.

    Byte-identical to the former per-tool ``_pct`` helpers: index
    ``int(q * n)`` clamped to the last element, ``None`` on empty input.
    """
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


# --------------------------------------------------------------------------- #
# Fixed-bucket histograms — the live-registry estimator.
# --------------------------------------------------------------------------- #

# Default latency bucket upper bounds (ms): 1 ms → ~2 min, roughly
# exponential.  Chosen so serving TTFT (tens–hundreds of ms) and train
# step times (hundreds–thousands of ms) both land mid-range.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 120000.0)


def bucket_index(bounds: Sequence[float], value: float) -> int:
    """Index of the bucket ``value`` falls into: ``bounds[i]`` is the
    inclusive upper bound of bucket ``i``; index ``len(bounds)`` is the
    +Inf overflow bucket."""
    return bisect.bisect_left(bounds, value)


def merge_bucket_counts(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Element-wise sum of two equal-shape bucket-count vectors.

    Histogram merge is associative and commutative (it is vector
    addition), which is what makes the cross-rank fold order-independent.
    """
    if len(a) != len(b):
        raise ValueError(
            f"histogram bucket mismatch: {len(a)} vs {len(b)} counts")
    return [int(x) + int(y) for x, y in zip(a, b)]


def quantile_from_buckets(bounds: Sequence[float], counts: Sequence[int],
                          q: float) -> Optional[float]:
    """Estimate the ``q``-quantile from fixed-bucket counts.

    Returns the upper bound of the bucket holding the target rank
    (Prometheus ``histogram_quantile``-style, without interpolation —
    conservative for SLO checks since the true value is ≤ the estimate).
    The overflow bucket reports the largest finite bound.
    """
    total = sum(int(c) for c in counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += int(c)
        if cum >= target and c:
            if i < len(bounds):
                return float(bounds[i])
            return float(bounds[-1])  # overflow bucket: clamp to last bound
    return float(bounds[-1])


# --------------------------------------------------------------------------- #
# Telemetry JSONL loading (rotation-aware).
# --------------------------------------------------------------------------- #

_ROT_SUFFIX = re.compile(r"\.(\d+)$")


def rotated_set(path: str) -> List[str]:
    """All files of a possibly-rotated JSONL set, oldest first.

    ``JsonlSink`` rotates ``telemetry.jsonl`` to ``telemetry.jsonl.1``,
    ``.2``, … (ascending = chronological), so the read order is the
    numeric rotations ascending followed by the live file.  A path with
    no rotated siblings returns ``[path]`` — the pre-rotation behavior.
    """
    out = []
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    try:
        names = os.listdir(d)
    except OSError:
        names = []
    rots = []
    for name in names:
        if not name.startswith(base + "."):
            continue
        m = _ROT_SUFFIX.search(name)
        if m and name == f"{base}.{m.group(1)}":
            rots.append((int(m.group(1)), os.path.join(d, name)))
    out.extend(p for _, p in sorted(rots))
    out.append(path)
    return out


def iter_jsonl(path: str):
    """Yield parsed dict records from one JSONL file, tolerating torn
    tail lines (a crashed run).  Raises OSError if unreadable."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue     # torn tail line from a crashed run
            if isinstance(rec, dict):
                yield rec


def load_records(path: str):
    """→ (records list, error string or None).

    The shared loader behind every offline report CLI: reads the full
    rotated set for ``path`` (oldest rotation first, live file last),
    keeps records carrying a ``kind``, tolerates torn tail lines, and
    rejects inputs with no parseable telemetry records.  For an
    un-rotated file this is behavior-identical to the loaders it
    replaced.
    """
    paths = [p for p in rotated_set(path) if os.path.isfile(p)]
    if not os.path.isfile(path) and not paths:
        return None, f"{path}: not a file"
    records: List[Dict[str, Any]] = []
    try:
        for p in paths:
            for rec in iter_jsonl(p):
                if "kind" in rec:
                    records.append(rec)
    except OSError as e:
        return None, f"unreadable {path}: {e}"
    if not records:
        return None, f"{path}: no telemetry records (wrong file?)"
    return records, None


# --------------------------------------------------------------------------- #
# Uniform report finalization — one output contract for every report CLI.
# --------------------------------------------------------------------------- #

# Version of the uniform CLI envelope (tool/report_schema keys + gates→ok
# convention), independent of each tool's own payload fields.
REPORT_SCHEMA = 1


def finalize_report(tool: str, report: Dict[str, Any],
                    gates: Optional[Dict[str, Any]] = None,
                    json_out: Optional[str] = None) -> int:
    """Stamp, print, optionally persist a report dict; return the exit code.

    The one output path shared by every report CLI (``serve_report``,
    ``offload_audit``, ``stability_report``, ``obs_report``,
    ``goodput_report``, ``bench_trend``): adds the uniform envelope keys
    *into* the report (``tool``, ``report_schema`` — existing top-level
    payload fields stay where tests and downstream autotuners expect
    them), merges ``gates`` under ``report["gates"]`` when given, prints
    the canonical sorted-JSON text, mirrors the *same text* to
    ``json_out`` when set, and returns 0/1 from ``report["ok"]``
    (missing ``ok`` means nothing was gated → 0).
    """
    report.setdefault("tool", tool)
    report.setdefault("report_schema", REPORT_SCHEMA)
    if gates is not None:
        report.setdefault("gates", {}).update(gates)
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if json_out:
        with open(json_out, "w") as f:
            f.write(text + "\n")
    return 0 if report.get("ok", True) else 1
