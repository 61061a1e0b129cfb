"""Declarative SLO rules with multiwindow burn-rate alerting (counterpart
of ``deepspeed_tpu/telemetry/slo.py``, the same host code).

An :class:`SLORule` names a registry metric, how to read it (histogram
quantile, gauge/counter value, counter ratio, or regression against a
self-captured baseline) and the objective bound.  The
:class:`SLOMonitor` samples each rule at evaluation cadence (the hub's
flush boundary in the live plane, replay order in
``tools/obs_report.py``), keeps a sliding window of violation samples,
and converts them into *error-budget burn rates* — the SRE multiwindow
scheme: with ``budget_frac`` the tolerated violating fraction,

    burn(window) = violating_fraction(window) / budget_frac

a **fast** alert (page) fires when the short window burns at ≥
``fast_burn``× budget, a **slow** alert (ticket) when the long window
sustains ≥ ``slow_burn``×.  Every transition into a burning state emits
an ``slo_burn`` telemetry event; recovery emits ``slo_clear``.  The
:meth:`SLOMonitor.verdict` dict is the machine-readable surface the
``/slo`` endpoint serves and the future autotuner scores against.

Rule grammar (config / ``telemetry.slo_rules`` entries)::

    {"name": "serve_p99_ttft_ms",          # unique rule id
     "metric": "serve_ttft_ms",            # registry metric key
     "op": "p99",                          # p50|p95|p99|value|ratio|regression
     "bound": 500.0,                       # objective (ratio: fraction;
                                           #  regression: factor over baseline)
     "cmp": "le",                          # le: value must stay ≤ bound
     "den": "sum:train_step_time_ms",      # ratio only: denominator ref
     "budget_frac": 0.05,                  # tolerated violating fraction
     "fast_window_s": 60, "slow_window_s": 600,
     "fast_burn": 10.0, "slow_burn": 2.0,
     "min_samples": 3}

Value refs for ``ratio`` operands: ``counter:NAME``, ``gauge:NAME``,
``sum:NAME`` / ``count:NAME`` (histogram), or a bare key searched across
sections.  Host-side logic only — evaluation reads registry snapshots
(already host floats).
"""

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.telemetry import stats as _stats

_QUANTILE_OPS = {"p50": 0.50, "p95": 0.95, "p99": 0.99}


class SLORule:
    """One declarative objective; see module docstring for the grammar."""

    def __init__(self, name: str, metric: str, op: str, bound: float,
                 cmp: str = "le", den: Optional[str] = None,
                 budget_frac: float = 0.05,
                 fast_window_s: float = 60.0, slow_window_s: float = 600.0,
                 fast_burn: float = 10.0, slow_burn: float = 2.0,
                 min_samples: int = 3, baseline_min_count: int = 20):
        if op not in ("value", "ratio", "regression") and op not in _QUANTILE_OPS:
            raise ValueError(f"SLO rule {name}: unknown op {op!r}")
        if cmp not in ("le", "ge"):
            raise ValueError(f"SLO rule {name}: cmp must be 'le' or 'ge'")
        if op == "ratio" and not den:
            raise ValueError(f"SLO rule {name}: ratio op needs a 'den' ref")
        if not (0.0 < float(budget_frac) <= 1.0):
            raise ValueError(f"SLO rule {name}: budget_frac must be in (0, 1]")
        self.name = name
        self.metric = metric
        self.op = op
        self.bound = float(bound)
        self.cmp = cmp
        self.den = den
        self.budget_frac = float(budget_frac)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.min_samples = int(min_samples)
        self.baseline_min_count = int(baseline_min_count)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLORule":
        known = ("name", "metric", "op", "bound", "cmp", "den", "budget_frac",
                 "fast_window_s", "slow_window_s", "fast_burn", "slow_burn",
                 "min_samples", "baseline_min_count")
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(f"SLO rule: unknown keys {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "metric": self.metric, "op": self.op,
             "bound": self.bound, "cmp": self.cmp,
             "budget_frac": self.budget_frac,
             "fast_window_s": self.fast_window_s,
             "slow_window_s": self.slow_window_s,
             "fast_burn": self.fast_burn, "slow_burn": self.slow_burn,
             "min_samples": self.min_samples}
        if self.den:
            d["den"] = self.den
        return d


def default_rules(serve_p99_ttft_ms: float = 2000.0,
                  offload_stall_frac: float = 0.15,
                  step_time_factor: float = 1.5,
                  collective_p99_skew_ms: float = 1000.0) -> List[SLORule]:
    """The stock objectives, with relaxed default bounds (tighten per
    deployment via ``telemetry.slo_rules``).  The collective-skew rule
    bounds the p99 first-vs-last rank arrival gap the collective health
    plane folds into ``collective_skew_ms`` — a chronic straggler burns
    this long before it shows up as a step-time regression."""
    return [
        SLORule("serve_p99_ttft_ms", "serve_ttft_ms", "p99",
                serve_p99_ttft_ms, cmp="le"),
        SLORule("offload_stall_frac", "counter:offload_stall_ms_total",
                "ratio", offload_stall_frac, cmp="le",
                den="sum:train_step_time_ms"),
        SLORule("step_time_regression", "train_step_time_ms", "regression",
                step_time_factor, cmp="le"),
        SLORule("collective_p99_skew_ms", "collective_skew_ms", "p99",
                collective_p99_skew_ms, cmp="le"),
    ]


def _lookup(snapshot: Dict[str, Any], ref: str):
    """Resolve a value ref (see module docstring) against a snapshot."""
    section = None
    name = ref
    if ":" in ref:
        section, name = ref.split(":", 1)
    if section in (None, "counter"):
        ent = (snapshot.get("counters") or {}).get(name)
        if ent is not None:
            return ent["value"]
        if section == "counter":
            return None
    if section in (None, "gauge"):
        ent = (snapshot.get("gauges") or {}).get(name)
        if ent is not None:
            return ent.get("value", ent.get("mean"))
        if section == "gauge":
            return None
    if section in ("sum", "count"):
        ent = (snapshot.get("histograms") or {}).get(name)
        if ent is None:
            return None
        return ent[section]
    return None


class SLOMonitor:
    """Samples rules against registry snapshots and runs the burn-rate
    state machine.  States per rule: ``ok`` → ``burn_slow`` → ``burn_fast``
    (and back).  ``telemetry`` (a TelemetryHub, optional) receives the
    ``slo_burn`` / ``slo_clear`` events; ``clock`` is injectable so tests
    never sleep."""

    def __init__(self, rules: Sequence[SLORule], registry=None,
                 telemetry=None, clock=time.monotonic):
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names in {names}")
        self.registry = registry
        self.telemetry = telemetry
        self._clock = clock
        self._samples: Dict[str, deque] = {r.name: deque() for r in self.rules}
        self._state: Dict[str, str] = {r.name: "ok" for r in self.rules}
        self._last: Dict[str, Dict[str, Any]] = {}
        self._baseline: Dict[str, float] = {}
        self.burn_events = 0

    # -- rule sampling ---------------------------------------------------- #
    def _rule_value(self, rule: SLORule, snapshot: Dict[str, Any]):
        if rule.op in _QUANTILE_OPS:
            h = (snapshot.get("histograms") or {}).get(rule.metric)
            if h is None or not h["count"]:
                return None
            return _stats.quantile_from_buckets(h["bounds"], h["counts"],
                                                _QUANTILE_OPS[rule.op])
        if rule.op == "value":
            return _lookup(snapshot, rule.metric)
        if rule.op == "ratio":
            num = _lookup(snapshot, rule.metric)
            den = _lookup(snapshot, rule.den)
            if num is None or not den:
                return None
            return num / den
        if rule.op == "regression":
            h = (snapshot.get("histograms") or {}).get(rule.metric)
            if h is None or h["count"] < rule.baseline_min_count:
                return None
            p50 = _stats.quantile_from_buckets(h["bounds"], h["counts"], 0.50)
            base = self._baseline.get(rule.name)
            if base is None:
                self._baseline[rule.name] = p50
                return None          # baseline capture sample, never violates
            if not base:
                return None
            return p50 / base        # violated when ratio exceeds the factor
        return None

    @staticmethod
    def _violated(rule: SLORule, value) -> bool:
        if value is None:
            return False
        if rule.cmp == "le":
            return value > rule.bound
        return value < rule.bound

    def _burn(self, rule: SLORule, now: float, window_s: float):
        """(burn rate, samples in window) for one sliding window."""
        cutoff = now - window_s
        n = bad = 0
        for t, v in self._samples[rule.name]:
            if t >= cutoff:
                n += 1
                bad += 1 if v else 0
        if n == 0:
            return 0.0, 0
        return (bad / n) / rule.budget_frac, n

    # -- evaluation ------------------------------------------------------- #
    def evaluate(self, now: Optional[float] = None,
                 snapshot: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Sample every rule once, advance the state machines, emit burn
        events on transitions, return the verdict."""
        if now is None:
            now = self._clock()
        if snapshot is None:
            snapshot = self.registry.snapshot() if self.registry else {}
        for rule in self.rules:
            value = self._rule_value(rule, snapshot)
            violated = self._violated(rule, value)
            win = self._samples[rule.name]
            if value is not None:
                win.append((now, violated))
            cutoff = now - rule.slow_window_s
            while win and win[0][0] < cutoff:
                win.popleft()
            fast_burn, fast_n = self._burn(rule, now, rule.fast_window_s)
            slow_burn, slow_n = self._burn(rule, now, rule.slow_window_s)
            prev = self._state[rule.name]
            state = "ok"
            if fast_n >= rule.min_samples and fast_burn >= rule.fast_burn:
                state = "burn_fast"
            elif slow_n >= rule.min_samples and slow_burn >= rule.slow_burn:
                state = "burn_slow"
            self._state[rule.name] = state
            self._last[rule.name] = {
                "state": state, "value": value, "bound": rule.bound,
                "op": rule.op, "cmp": rule.cmp, "violated": violated,
                "burn_fast": round(fast_burn, 4),
                "burn_slow": round(slow_burn, 4),
                "samples_fast": fast_n, "samples_slow": slow_n,
            }
            if state != prev:
                self._transition(rule, prev, state)
        return self.verdict()

    def _transition(self, rule: SLORule, prev: str, state: str):
        info = self._last[rule.name]
        if state == "ok":
            self._emit("slo_clear", {"rule": rule.name, "from": prev})
            return
        self.burn_events += 1
        severity = "fast" if state == "burn_fast" else "slow"
        self._emit("slo_burn", {
            "rule": rule.name, "severity": severity, "from": prev,
            "value": info["value"], "bound": rule.bound,
            "burn_fast": info["burn_fast"], "burn_slow": info["burn_slow"],
        })

    def _emit(self, kind: str, payload: Dict[str, Any]):
        if self.telemetry is not None:
            try:
                self.telemetry.emit(kind, payload)
            except Exception:
                pass

    # -- machine-readable surface ------------------------------------------ #
    def verdict(self) -> Dict[str, Any]:
        rules = {}
        for rule in self.rules:
            rules[rule.name] = dict(self._last.get(
                rule.name, {"state": "ok", "value": None,
                            "bound": rule.bound, "op": rule.op,
                            "cmp": rule.cmp, "violated": False,
                            "burn_fast": 0.0, "burn_slow": 0.0,
                            "samples_fast": 0, "samples_slow": 0}))
        ok = all(r["state"] == "ok" for r in rules.values())
        burning = sorted(n for n, r in rules.items() if r["state"] != "ok")
        return {"ok": ok, "burning": burning,
                "burn_events": self.burn_events, "rules": rules}

    def state_for_metric(self, metric: str) -> str:
        """Worst current burn state among rules sampling ``metric``
        (``ok`` < ``burn_slow`` < ``burn_fast``) — the serving admission
        ladder reads the TTFT rules this way without re-evaluating."""
        rank = {"ok": 0, "burn_slow": 1, "burn_fast": 2}
        worst = "ok"
        for rule in self.rules:
            if rule.metric.split(":", 1)[-1] != metric:
                continue
            state = self._state.get(rule.name, "ok")
            if rank.get(state, 0) > rank[worst]:
                worst = state
        return worst


def rules_from_config(specs, defaults: bool = True) -> List[SLORule]:
    """Build the rule list from ``telemetry.slo_rules`` config entries —
    a falsy spec list yields the stock :func:`default_rules` (when
    ``defaults``), explicit entries replace them wholesale."""
    if specs:
        return [r if isinstance(r, SLORule) else SLORule.from_dict(dict(r))
                for r in specs]
    return default_rules() if defaults else []
