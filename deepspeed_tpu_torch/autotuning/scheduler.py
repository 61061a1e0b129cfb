"""Experiment scheduler: subprocess trials with a reaped lifecycle
(counterpart of ``deepspeed_tpu/autotuning/scheduler.py``).

Two layers:

* :class:`TrialScheduler` — the closed loop's executor.  One trial is
  one subprocess in its OWN process group (``start_new_session=True``)
  whose ds_config is written to the trial dir and pointed at by
  ``DS_AUTOTUNING_CONFIG``; the trial's telemetry is forced on so it
  drops the per-trial ``EFFICIENCY.json`` the scorer ranks.  A trial
  that exceeds its deadline is SIGTERMed, grace-waited, SIGKILLed, and
  the whole group swept with ``waitpid(-pgid)`` (the elastic agent's reap
  discipline — launcher grandchildren must not linger as zombies), then
  recorded as **degraded** — a wedged trial never eats the search
  budget, it just loses.  Crashed trials (rc != 0, such as one whose
  engine raises ``NotImplementedError`` on a ZeRO++ or NVMe candidate of
  JAX's default space) and trials whose ledger fails its conservation
  check are likewise recorded degraded, never silently dropped: every
  launched trial leaves a result row.

* :class:`ResourceManager` — the seed-era interface (command template +
  ``metrics.json`` scalar), kept for scripts that drive their own
  training command (the launcher's ``--autotuning``); ``run_experiment``
  returns the bare metric.

Thread contract: the scheduler may be driven from a tuner thread while
an observer reads ``status()``; the bookkeeping dicts are guarded by
``_lock``, and no blocking call — the child wait, the reap sweep, file
I/O — ever runs under it.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from deepspeed_tpu_torch.autotuning.scoring import TrialScore, score_from_efficiency
from deepspeed_tpu_torch.utils.logging import log_dist

METRIC_PATH_ENV = "DS_AUTOTUNING_METRIC_PATH"
CONFIG_PATH_ENV = "DS_AUTOTUNING_CONFIG"

#: trial artifact filenames inside each trial dir
TRIAL_CONFIG = "ds_config.json"
TRIAL_EFFICIENCY = "EFFICIENCY.json"
TRIAL_LOG = "stdout.log"

#: trial result statuses
SCORED = "scored"
DEGRADED = "degraded"
PRUNED = "pruned"          # stamped by the loop, never by the scheduler


def reap_group(proc: subprocess.Popen, grace_s: float = 5.0) -> Optional[int]:
    """Terminate and REAP ``proc``'s whole process group: SIGTERM, grace
    wait, SIGKILL, then a scoped ``waitpid(-pgid)`` sweep so trial
    grandchildren (launcher workers, staging helpers) cannot linger as
    zombies across a long search.  Returns the leader's exit code."""
    rc = proc.poll()
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        pgid = proc.pid
    if rc is None:
        try:
            os.killpg(pgid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            rc = proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            rc = proc.wait()
    # sweep the rest of the group (scoped to -pgid: never steal other
    # children of this process)
    while True:
        try:
            pid, _status = os.waitpid(-pgid, os.WNOHANG)
        except ChildProcessError:
            break
        if pid == 0:
            break
    return rc


@dataclass
class TrialResult:
    """One launched (or pruned) trial's provenance row."""
    name: str
    status: str                       # scored | degraded | pruned
    ds_config: Dict = field(default_factory=dict)
    patch: Dict = field(default_factory=dict)
    knobs: Dict = field(default_factory=dict)
    rc: Optional[int] = None
    timed_out: bool = False
    score: Optional[TrialScore] = None
    error: Optional[str] = None
    trial_dir: Optional[str] = None
    efficiency_path: Optional[str] = None
    duration_s: float = 0.0
    prune_reason: Optional[str] = None

    @property
    def scored(self) -> bool:
        return self.status == SCORED and self.score is not None

    def as_record(self) -> Dict:
        rec = {
            "name": self.name,
            "status": self.status,
            "patch": self.patch,
            "knobs": self.knobs,
            "rc": self.rc,
            "timed_out": self.timed_out,
            "score": self.score.as_record() if self.score else None,
            "error": self.error,
            "trial_dir": self.trial_dir,
            "duration_s": round(self.duration_s, 3),
        }
        if self.prune_reason is not None:
            rec["prune_reason"] = self.prune_reason
        return rec


class TrialScheduler:
    """Run scored trials as reaped subprocesses.

    ``cmd`` is the trial command (argv); default is the built-in runner
    ``python -m deepspeed_tpu_torch.autotuning.trial`` which builds an
    engine from the trial's ds_config and steps it on the card (append
    ``--device cpu`` to run it on the CPU).  ``env`` overlays the inherited
    environment for every trial.
    """

    def __init__(self, exps_dir: str, cmd: Optional[List[str]] = None,
                 timeout_s: float = 600.0, reap_grace_s: float = 5.0,
                 env: Optional[Dict[str, str]] = None):
        self.exps_dir = exps_dir
        self.cmd = list(cmd) if cmd else [sys.executable, "-m",
                                          "deepspeed_tpu_torch.autotuning.trial"]
        self.timeout_s = float(timeout_s)
        self.reap_grace_s = float(reap_grace_s)
        self.env = dict(env or {})
        self._lock = threading.Lock()
        self._running: Dict[str, int] = {}   # guarded-by: _lock (name->pid)
        self.results: List[TrialResult] = []  # guarded-by: _lock
        os.makedirs(exps_dir, exist_ok=True)

    # -- bookkeeping (observer-safe) ------------------------------------- #
    def status(self) -> Dict[str, int]:
        with self._lock:
            scored = sum(1 for r in self.results if r.scored)
            degraded = sum(1 for r in self.results if r.status == DEGRADED)
            running = len(self._running)
        return {"scored": scored, "degraded": degraded, "running": running}

    def _record(self, result: TrialResult):
        with self._lock:
            self._running.pop(result.name, None)
            self.results.append(result)

    # -- execution -------------------------------------------------------- #
    def trial_dir(self, name: str) -> str:
        d = os.path.join(self.exps_dir, name)
        os.makedirs(d, exist_ok=True)
        return d

    def _prepare_config(self, trial_dir: str, ds_config: Dict) -> Dict:
        """Force the telemetry the scorer needs into the trial config:
        goodput ledger on, EFFICIENCY.json + telemetry JSONL in the
        trial dir (unless the caller already routed them)."""
        cfg = json.loads(json.dumps(ds_config))     # deep, JSON-safe copy
        tele = cfg.setdefault("telemetry", {})
        tele.setdefault("enabled", True)
        tele.setdefault("goodput", True)
        tele.setdefault("jsonl_path", os.path.join(trial_dir,
                                                   "telemetry.jsonl"))
        tele.setdefault("efficiency_json_path",
                        os.path.join(trial_dir, TRIAL_EFFICIENCY))
        return cfg

    def run_trial(self, name: str, ds_config: Dict,
                  extra_env: Optional[Dict[str, str]] = None,
                  patch: Optional[Dict] = None,
                  knobs: Optional[Dict] = None) -> TrialResult:
        """Launch one trial to completion (or reap) and score it."""
        trial_dir = self.trial_dir(name)
        cfg = self._prepare_config(trial_dir, ds_config)
        cfg_path = os.path.join(trial_dir, TRIAL_CONFIG)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2, sort_keys=True)
        eff_path = cfg["telemetry"]["efficiency_json_path"]

        env = dict(os.environ)
        env.update(self.env)
        env.update(extra_env or {})
        env[CONFIG_PATH_ENV] = cfg_path
        env[METRIC_PATH_ENV] = os.path.join(trial_dir, "metrics.json")

        result = TrialResult(name=name, status=DEGRADED, ds_config=cfg,
                             patch=dict(patch or {}), knobs=dict(knobs or {}),
                             trial_dir=trial_dir, efficiency_path=eff_path)
        t0 = time.monotonic()
        log_path = os.path.join(trial_dir, TRIAL_LOG)
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(self.cmd, env=env, stdout=log_f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        with self._lock:
            self._running[name] = proc.pid
        try:
            try:
                rc = proc.wait(timeout=self.timeout_s)
            except subprocess.TimeoutExpired:
                # the per-trial hang watchdog fired: reap the whole group
                # and score the trial degraded — it lost, the search didn't
                result.timed_out = True
                result.error = (f"trial exceeded {self.timeout_s:.1f}s "
                                "deadline; process group reaped")
                rc = reap_group(proc, grace_s=self.reap_grace_s)
            result.rc = rc
            result.duration_s = time.monotonic() - t0
            if result.timed_out:
                return result
            if rc != 0:
                result.error = f"trial exited rc={rc} (see {log_path})"
                return result
            score, err = score_from_efficiency(eff_path)
            if score is None:
                result.error = err
                return result
            if not score.conservation_ok:
                result.score = score
                result.error = ("ledger failed its conservation check — "
                                "mis-instrumented run, not scored")
                return result
            result.score = score
            result.status = SCORED
            return result
        finally:
            self._record(result)
            log_dist(f"autotuning: trial {name} {result.status}"
                     + (f" goodput={result.score.goodput_frac:.3f}"
                        if result.score else "")
                     + (f" ({result.error})" if result.error else ""),
                     ranks=[0])


# --------------------------------------------------------------------------- #
# Legacy interface (seed-era): command template + metrics.json scalar.
# --------------------------------------------------------------------------- #


class ResourceManager:
    """Run experiments and collect metric values (seed-era interface).

    ``cmd`` is the training command template (list of argv tokens); each
    experiment gets its own directory with ``ds_config.json`` +
    ``metrics.json`` and the env vars ``DS_AUTOTUNING_CONFIG`` /
    ``DS_AUTOTUNING_METRIC_PATH`` pointing at them.  Timed-out or
    crashed experiments return ``None`` and stay in
    ``finished_experiments`` — same contract as before, now with the
    group reap of :func:`reap_group` instead of an orphaning kill."""

    def __init__(self, exps_dir: str, cmd: Optional[List[str]] = None,
                 metric: str = "throughput", timeout: int = 1800):
        self.exps_dir = exps_dir
        self.cmd = cmd
        self.metric = metric
        self.timeout = timeout
        self.finished_experiments: List[Dict] = []
        os.makedirs(exps_dir, exist_ok=True)

    def experiment_dir(self, name: str) -> str:
        d = os.path.join(self.exps_dir, name)
        os.makedirs(d, exist_ok=True)
        return d

    def run_experiment(self, name: str, ds_config: Dict) -> Optional[float]:
        """Launch one experiment; returns the metric value or None."""
        exp_dir = self.experiment_dir(name)
        cfg_path = os.path.join(exp_dir, TRIAL_CONFIG)
        metric_path = os.path.join(exp_dir, "metrics.json")
        with open(cfg_path, "w") as f:
            json.dump(ds_config, f, indent=2)
        env = dict(os.environ)
        env[CONFIG_PATH_ENV] = cfg_path
        env[METRIC_PATH_ENV] = metric_path
        log_path = os.path.join(exp_dir, TRIAL_LOG)
        assert self.cmd, "ResourceManager needs a training command"
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(self.cmd, env=env, stdout=log_f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = proc.wait(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                rc = reap_group(proc)
        val = self.parse_results(metric_path)
        self.finished_experiments.append(
            {"name": name, "ds_config": ds_config, "rc": rc,
             self.metric: val, "exp_dir": exp_dir})
        return val if rc == 0 else None

    def parse_results(self, metric_path: str) -> Optional[float]:
        if not os.path.exists(metric_path):
            return None
        try:
            with open(metric_path) as f:
                data = json.load(f)
            return float(data.get(self.metric)) if self.metric in data else None
        except (ValueError, TypeError, OSError):
            return None

    def status(self) -> str:
        ok = sum(1 for e in self.finished_experiments if e[self.metric] is not None)
        return f"{ok}/{len(self.finished_experiments)} experiments succeeded"

    def clear(self):
        self.finished_experiments = []


def write_metrics(path: str, metrics: Dict):
    """Engine-side metric dump (atomic-ish)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(metrics, f)
    os.replace(tmp, path)
