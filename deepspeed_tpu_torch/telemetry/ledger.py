"""Goodput & efficiency attribution ledger (counterpart of
``deepspeed_tpu/telemetry/ledger.py``, the same host code; its
``EFFICIENCY.json`` is the JAX package's).

``GoodputLedger`` attributes every wall-clock second of a train or serve
run into exhaustive, mutually exclusive categories, with a conservation
invariant: the categories always sum to the measured wall time (the
residual category ``idle_other`` absorbs whatever the instrumented seams
did not claim, clamped at zero).  The categories:

==================== ===================================================
``productive``       step compute that advanced training/serving state
``exposed_comm``     collective time not hidden behind compute (fed from
                     trace-derived measurements when available)
``offload_stall``    blocking beyond-HBM staging waits inside a step
                     (``runtime/engine._emit_offload_telemetry`` deltas;
                     serving restage waits land here too)
``ckpt_stall``       blocking checkpoint save/finalize time
                     (``save_checkpoint`` + finalizer joins)
``rollback_recompute`` steps replayed between a rollback target and the
                     previously reached step (``auto_rollback``)
``quarantine_skip``  step share burned running no-op micro-steps over
                     quarantined batches
``downtime``         preemption/restart gap (elastic-agent ``downtime``
                     events; in-process via :meth:`note_downtime`)
``hang``             watchdog-detected stall time (per-step wall beyond
                     the watchdog threshold)
``comm_recovery``    coordinated collective-recovery time: detect →
                     abort barrier → retry/shrink → resume
                     (``comm/recovery.py`` books it per incident)
``idle_other``       residual: wall - sum(everything above), >= 0
==================== ===================================================

Derived top-line gauges: ``goodput_frac`` (productive / wall), ``mfu``
(productive FLOPs over peak, when FLOPs inputs are wired), and
``lost_work_steps`` (steps whose results a rollback discarded).

The attribution model is mark-based: the ledger keeps a monotonic
``_last_mark``; :meth:`on_step` (the hot path — zero-sync, host floats
only) attributes the span since the last mark, splitting out hang
excess, offload stall, exposed comm, and quarantine share, and crediting
the remainder to ``productive`` — or to ``rollback_recompute`` while the
run is replaying steps at or below the last rollback's ``from_step``.
Out-of-step stalls (:meth:`note_ckpt_stall`, :meth:`note_downtime`,
:meth:`note_quarantine_skip` with a duration) advance the mark by the
same amount so the next step's span never double-counts them —
conservation holds by construction, and :meth:`conservation` proves it.

Cross-rank: when constructed with a ``MetricsRegistry`` the ledger
mirrors each category into ``goodput_seconds_total{category=...}``
counters (SUM-folded by ``pack_snapshot``/``fold_packed_over_mesh``) and
exposes the derived gauges, so ``render_prometheus`` publishes the
``dstpu_goodput_*`` series and ``/goodput`` on the obs server serves
:meth:`snapshot` live.

Offline: :func:`fold_goodput` folds the ``goodput``/``downtime`` records
of a telemetry JSONL set (one cumulative snapshot per attempt — restarts
are separate attempts keyed by ``run_id``) into the same shape, which is
what ``tools/goodput_report.py`` gates and what the per-run
``EFFICIENCY.json`` artifact (:meth:`write_efficiency_json`) snapshots —
the single scoring input the ROADMAP item-2 autotuner consumes.

Standard library only — the module is loaded by file path from the
no-jax report CLIs.
"""

import json
import os
import time

SCHEMA_VERSION = 1

#: exhaustive, mutually exclusive wall-time categories (seconds)
CATEGORIES = (
    "productive",
    "exposed_comm",
    "offload_stall",
    "ckpt_stall",
    "rollback_recompute",
    "quarantine_skip",
    "downtime",
    "hang",
    "comm_recovery",
    "idle_other",
)

#: accumulating categories (everything except the derived residual)
_ACCUMULATED = tuple(c for c in CATEGORIES if c != "idle_other")

#: default per-SLO-class TTFT bounds (ms) for serve goodput; a request's
#: tokens count as delivered-within-bound when its TTFT met its class
DEFAULT_SLO_TTFT_BOUNDS_MS = {
    "interactive": 500.0,
    "standard": 2000.0,
    "batch": 30000.0,
}


class GoodputLedger:
    """Attribute every second of a run into the category taxonomy.

    Parameters
    ----------
    mode : ``"train"`` or ``"serve"`` — stamped on snapshots.
    registry : optional ``MetricsRegistry``; when given the categories
        and gauges are mirrored into ``goodput_*`` metrics.
    clock : monotonic clock (injectable for tests).
    hang_threshold_s : per-step wall beyond this is attributed to
        ``hang`` (wire to the watchdog timeout; 0 disables).
    flops_per_step : number or zero-arg callable -> model FLOPs per
        optimizer step (may return None early in a run).
    peak_flops_per_s : peak sustained FLOPs/s of one chip; with
        ``flops_per_step`` this enables the ``mfu`` gauge.
    run_id : attempt identity carried on every snapshot so the offline
        fold can group records per process incarnation; defaults to
        ``"<pid>-<start-ms>"``.
    """

    def __init__(self, mode="train", registry=None, clock=time.monotonic,
                 hang_threshold_s=0.0, flops_per_step=None,
                 peak_flops_per_s=None, run_id=None):
        self.mode = mode
        self._clock = clock
        self.hang_threshold_s = float(hang_threshold_s)
        self.flops_per_step = flops_per_step
        self.peak_flops_per_s = peak_flops_per_s
        self._start = clock()
        self.start_unix = time.time()
        self.run_id = run_id or "%d-%d" % (os.getpid(),
                                           int(self.start_unix * 1000.0))
        self._last_mark = self._start
        self._cats = {c: 0.0 for c in _ACCUMULATED}
        self.steps = 0
        self.productive_steps = 0
        self.lost_work_steps = 0
        self.rollbacks = 0
        self.quarantine_skips = 0
        self.replay_until = -1          # steps <= this are recompute
        # straggler share: the part of exposed_comm attributable to
        # cross-rank arrival skew (a sub-accounting, NOT a category —
        # conservation is untouched; fed by the collective-health fold)
        self.exposed_comm_straggler_s = 0.0
        #: per-SLO-class TTFT bounds (ms); engines may override per config
        self.slo_ttft_bounds_ms = dict(DEFAULT_SLO_TTFT_BOUNDS_MS)
        self._serve = {}                # slo -> token accounting
        self._c_cat = None
        if registry is not None:
            self._c_cat = {
                c: registry.counter(
                    "goodput_seconds_total", labels={"category": c},
                    help="wall-clock seconds attributed per category")
                for c in _ACCUMULATED}
            self._c_steps = registry.counter(
                "goodput_steps_total", help="optimizer/serve steps accounted")
            registry.gauge("goodput_frac", fn=self._frac,
                           help="productive seconds / wall seconds")
            registry.gauge("goodput_mfu", fn=self._mfu_or_zero,
                           help="model FLOPs utilization over productive wall")
            registry.gauge("goodput_lost_work_steps",
                           fn=lambda: float(self.lost_work_steps),
                           help="steps a rollback discarded")
            registry.gauge("goodput_wall_seconds", fn=self._wall,
                           help="ledger wall clock (this attempt)")
            registry.gauge("goodput_idle_other_seconds", fn=self._idle,
                           help="wall seconds no instrumented seam claimed")
            registry.gauge("goodput_exposed_comm_straggler_frac",
                           fn=self._straggler_frac,
                           help="share of exposed_comm attributable to "
                                "cross-rank arrival skew")

    # ---- hot path ------------------------------------------------------ #

    def _acc(self, category, seconds):
        """Attribute ``seconds`` to one category (dict + mirror counter)."""
        if seconds <= 0.0:
            return
        self._cats[category] += seconds
        if self._c_cat is not None:
            self._c_cat[category].inc(seconds)

    def on_step(self, step, offload_wait_s=0.0, exposed_comm_s=0.0,
                quarantine_frac=0.0, now=None):
        """Attribute the span since the last mark to this step.

        Called once per optimizer step (train) or engine step (serve)
        from the step boundary.  ``offload_wait_s`` / ``exposed_comm_s``
        are the measured stall components of the span (clamped to it);
        ``quarantine_frac`` is the fraction of the step's micro-batches
        skipped over quarantined data.  Steps at or below the last
        rollback's origin are attributed to ``rollback_recompute``.
        """
        if now is None:
            now = self._clock()
        dt = now - self._last_mark
        self._last_mark = now
        if dt < 0.0:
            dt = 0.0
        self.steps += 1
        if self._c_cat is not None:
            self._c_steps.inc(1.0)
        rem = dt
        if self.hang_threshold_s > 0.0 and dt > self.hang_threshold_s:
            hang = dt - self.hang_threshold_s
            self._acc("hang", hang)
            rem -= hang
        stall = min(max(offload_wait_s, 0.0), rem)
        self._acc("offload_stall", stall)
        rem -= stall
        comm = min(max(exposed_comm_s, 0.0), rem)
        self._acc("exposed_comm", comm)
        rem -= comm
        if quarantine_frac > 0.0:
            skip = rem * min(quarantine_frac, 1.0)
            self._acc("quarantine_skip", skip)
            rem -= skip
        if step <= self.replay_until:
            self._acc("rollback_recompute", rem)
        else:
            self._acc("productive", rem)
            self.productive_steps += 1

    # ---- out-of-step seams --------------------------------------------- #

    def mark(self, now=None):
        """Advance the mark without attributing the skipped span (it
        falls to ``idle_other``) — e.g. past setup/compile phases."""
        self._last_mark = now if now is not None else self._clock()

    def _note(self, category, seconds):
        """Attribute an out-of-step stall and advance the mark past it so
        the next step's span does not count it again."""
        s = max(float(seconds), 0.0)
        self._acc(category, s)
        now = self._clock()
        self._last_mark = min(self._last_mark + s, now)

    def note_ckpt_stall(self, seconds):
        """Blocking checkpoint save/finalize time just spent."""
        self._note("ckpt_stall", seconds)

    def note_downtime(self, seconds):
        """Preemption/restart downtime observed in-process (cross-process
        downtime arrives via elastic-agent ``downtime`` events and is
        added by the offline fold)."""
        self._note("downtime", seconds)

    def note_hang(self, seconds):
        """Watchdog-measured stall time (explicit feed)."""
        self._note("hang", seconds)

    def note_comm_recovery(self, seconds):
        """Coordinated collective-recovery time just spent (deadline
        expiry → abort barrier → ladder rung → resume).  Booked by the
        recovery manager per incident; mark-advancing like every
        out-of-step stall, so conservation holds by construction."""
        self._note("comm_recovery", seconds)

    def note_straggler_share(self, seconds):
        """The collective-health fold measured ``seconds`` of cross-rank
        arrival skew: book it as the straggler share of ``exposed_comm``.
        Sub-accounting only — it does not move the mark or any category,
        it explains how much of the already-attributed exposed_comm a
        straggling rank caused."""
        if seconds > 0.0:
            self.exposed_comm_straggler_s += float(seconds)

    def note_quarantine_skip(self, seconds=0.0):
        """A quarantined batch was skipped; ``seconds`` when measured
        out-of-step (in-step share is fed via ``quarantine_frac``)."""
        self.quarantine_skips += 1
        if seconds > 0.0:
            self._note("quarantine_skip", seconds)

    def on_rollback(self, from_step, to_step):
        """A rollback rewound ``from_step`` -> ``to_step``: the steps in
        between are lost work, and their replay is recompute."""
        lost = max(int(from_step) - int(to_step), 0)
        self.lost_work_steps += lost
        self.rollbacks += 1
        if from_step > self.replay_until:
            self.replay_until = int(from_step)

    # ---- serve goodput -------------------------------------------------- #

    def note_serve_request(self, slo, ttft_ms, new_tokens):
        """A request finished: its tokens count as delivered within bound
        when TTFT met the class bound, late otherwise."""
        s = self._serve.setdefault(str(slo), {
            "finished": 0, "tokens_in_bound": 0, "tokens_late": 0,
            "wasted_prefill_tokens": 0})
        s["finished"] += 1
        bound = self.slo_ttft_bounds_ms.get(
            str(slo), DEFAULT_SLO_TTFT_BOUNDS_MS["standard"])
        if ttft_ms is not None and float(ttft_ms) <= bound:
            s["tokens_in_bound"] += int(new_tokens)
        else:
            s["tokens_late"] += int(new_tokens)

    def note_wasted_prefill(self, slo, tokens):
        """An eviction discarded KV that must be re-prefilled: ``tokens``
        of prefill compute were wasted."""
        if tokens <= 0:
            return
        s = self._serve.setdefault(str(slo), {
            "finished": 0, "tokens_in_bound": 0, "tokens_late": 0,
            "wasted_prefill_tokens": 0})
        s["wasted_prefill_tokens"] += int(tokens)

    def note_serve_expired(self, slo, tokens_wasted=0):
        """A request's deadline passed before it finished: count the
        cancellation and book whatever prefill it had accumulated as
        wasted compute."""
        s = self._serve.setdefault(str(slo), {
            "finished": 0, "tokens_in_bound": 0, "tokens_late": 0,
            "wasted_prefill_tokens": 0})
        s["expired"] = s.get("expired", 0) + 1
        if tokens_wasted > 0:
            s["wasted_prefill_tokens"] += int(tokens_wasted)

    # ---- derived views -------------------------------------------------- #

    def _wall(self, now=None):
        return (now if now is not None else self._clock()) - self._start

    def _idle(self, now=None):
        wall = self._wall(now)
        return max(0.0, wall - sum(self._cats.values()))

    def _frac(self, now=None):
        wall = self._wall(now)
        return self._cats["productive"] / wall if wall > 0.0 else 0.0

    def _mfu(self, now=None):
        peak = self.peak_flops_per_s
        flops = self.flops_per_step
        if callable(flops):
            try:
                flops = flops()
            except Exception:
                flops = None
        if not peak or not flops:
            return None
        wall = self._wall(now)
        if wall <= 0.0:
            return None
        return (float(flops) * self.productive_steps) / (wall * float(peak))

    def _mfu_or_zero(self):
        return self._mfu() or 0.0

    def _straggler_frac(self):
        comm = self._cats["exposed_comm"]
        if comm <= 0.0:
            return 0.0
        return min(self.exposed_comm_straggler_s / comm, 1.0)

    def snapshot(self, now=None):
        """Cumulative attribution snapshot (conserves by construction)."""
        if now is None:
            now = self._clock()
        wall = self._wall(now)
        cats = {c: self._cats[c] for c in _ACCUMULATED}
        cats["idle_other"] = max(0.0, wall - sum(cats.values()))
        snap = {
            "schema": SCHEMA_VERSION,
            "mode": self.mode,
            "run_id": self.run_id,
            "start_unix": self.start_unix,
            "wall_s": wall,
            "categories": cats,
            "steps": self.steps,
            "productive_steps": self.productive_steps,
            "lost_work_steps": self.lost_work_steps,
            "rollbacks": self.rollbacks,
            "quarantine_skips": self.quarantine_skips,
            "goodput_frac": self._frac(now),
            "mfu": self._mfu(now),
            "exposed_comm_straggler_s": self.exposed_comm_straggler_s,
            "exposed_comm_straggler_frac": self._straggler_frac(),
        }
        if self._serve:
            snap["serve"] = serve_summary(self._serve)
        snap["conservation"] = conservation(snap)
        return snap

    def conservation(self, snap=None, eps=0.01):
        """Check categories sum to wall within ``eps`` (fractional)."""
        return conservation(snap or self.snapshot(), eps=eps)

    def write_efficiency_json(self, path, snap=None, extra=None):
        """Write the per-run ``EFFICIENCY.json`` artifact — the scoring
        input for the autotuner (ROADMAP item 2).  Atomic replace."""
        doc = {
            "schema": SCHEMA_VERSION,
            "generated_unix": time.time(),
            "source": "live",
            "ledger": snap if snap is not None else self.snapshot(),
        }
        if extra:
            doc.update(extra)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return doc


# ---- pure folds (shared with tools/goodput_report.py) ------------------- #

def serve_summary(by_slo):
    """Roll per-SLO token accounting up into the serve goodput view."""
    total_in = sum(s["tokens_in_bound"] for s in by_slo.values())
    total_late = sum(s["tokens_late"] for s in by_slo.values())
    total_waste = sum(s["wasted_prefill_tokens"] for s in by_slo.values())
    total_expired = sum(s.get("expired", 0) for s in by_slo.values())
    denom = total_in + total_late + total_waste
    out = {
        "by_slo": {k: dict(v) for k, v in sorted(by_slo.items())},
        "tokens_in_bound": total_in,
        "tokens_late": total_late,
        "wasted_prefill_tokens": total_waste,
        "expired": total_expired,
        "goodput_tokens_frac": (total_in / denom) if denom else None,
    }
    return out


def conservation(snap, eps=0.01):
    """Conservation verdict for one snapshot (or fold) dict: do the
    categories sum to the wall time within ``eps`` of it?"""
    wall = float(snap.get("wall_s", 0.0))
    total = sum(float(v) for v in snap.get("categories", {}).values())
    abs_err = abs(total - wall)
    frac_err = (abs_err / wall) if wall > 0.0 else 0.0
    return {
        "sum_s": total,
        "wall_s": wall,
        "abs_err_s": abs_err,
        "frac_err": frac_err,
        "eps": eps,
        "ok": frac_err <= eps,
    }


def _merge_serve(folded, serve):
    for slo, s in serve.get("by_slo", {}).items():
        dst = folded.setdefault(slo, {
            "finished": 0, "tokens_in_bound": 0, "tokens_late": 0,
            "wasted_prefill_tokens": 0, "expired": 0})
        for key in dst:
            dst[key] += int(s.get(key, 0))


def fold_goodput(records, eps=0.01):
    """Fold the ``goodput``/``downtime`` records of a telemetry JSONL set
    into one run-level report.

    Each process incarnation (attempt) emits cumulative ``goodput``
    snapshots under its own ``run_id`` — the last one per attempt wins.
    Elastic-agent ``downtime`` events measure the gaps BETWEEN attempts,
    so their seconds are added to both the ``downtime`` category and the
    total wall (conservation is preserved).  Returns None when the set
    carries no goodput records.
    """
    last_by_attempt = {}
    order = []
    downtime_s = 0.0
    downtime_events = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "goodput":
            rid = str(rec.get("run_id", "?"))
            if rid not in last_by_attempt:
                order.append(rid)
            last_by_attempt[rid] = rec
        elif kind == "downtime":
            try:
                downtime_s += float(rec.get("downtime_s", 0.0))
                downtime_events += 1
            except (TypeError, ValueError):
                pass
    if not last_by_attempt:
        return None

    cats = {c: 0.0 for c in CATEGORIES}
    wall = 0.0
    steps = productive_steps = lost = rollbacks = skips = 0
    serve_by_slo = {}
    mfu_vals = []
    mode = None
    straggler_s = 0.0
    for rid in order:
        snap = last_by_attempt[rid]
        wall += float(snap.get("wall_s", 0.0))
        straggler_s += float(snap.get("exposed_comm_straggler_s", 0.0))
        for c, v in snap.get("categories", {}).items():
            if c in cats:
                cats[c] += float(v)
        steps += int(snap.get("steps", 0))
        productive_steps += int(snap.get("productive_steps", 0))
        lost += int(snap.get("lost_work_steps", 0))
        rollbacks += int(snap.get("rollbacks", 0))
        skips += int(snap.get("quarantine_skips", 0))
        if snap.get("mfu") is not None:
            mfu_vals.append(float(snap["mfu"]))
        mode = snap.get("mode", mode)
        if snap.get("serve"):
            _merge_serve(serve_by_slo, snap["serve"])
    cats["downtime"] += downtime_s
    wall += downtime_s

    report = {
        "schema": SCHEMA_VERSION,
        "mode": mode or "train",
        "attempts": len(order),
        "run_ids": order,
        "wall_s": wall,
        "categories": cats,
        "steps": steps,
        "productive_steps": productive_steps,
        "lost_work_steps": lost,
        "rollbacks": rollbacks,
        "quarantine_skips": skips,
        "downtime_events": downtime_events,
        "downtime_event_s": downtime_s,
        "goodput_frac": (cats["productive"] / wall) if wall > 0.0 else 0.0,
        "mfu": (sum(mfu_vals) / len(mfu_vals)) if mfu_vals else None,
        "exposed_comm_straggler_s": straggler_s,
        "exposed_comm_straggler_frac": (
            min(straggler_s / cats["exposed_comm"], 1.0)
            if cats["exposed_comm"] > 0.0 else 0.0),
    }
    if serve_by_slo:
        report["serve"] = serve_summary(serve_by_slo)
    report["conservation"] = conservation(report, eps=eps)
    return report
