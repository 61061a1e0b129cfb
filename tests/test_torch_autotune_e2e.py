"""The port's autotuner end to end on the CPU, in subprocesses (no JAX in
any child):

* the trial scheduler's lifecycle (as ``tests/unit/autotuning/
  test_scheduler_lifecycle.py`` holds the JAX package's): a trial whose
  leader and grandchild ignore SIGTERM is killed at its deadline and its
  whole process group reaped; a crashed trial is recorded degraded, never
  dropped;
* the launcher's ``--autotuning tune`` and ``run`` on a tiny GPT worker
  (``tests/torch_autotune_worker.py --device cpu``): ``ds_config_optimal.json``
  is the experiment with the largest recorded metric, and ``run``'s final
  job trains with it;
* the closed loop with the built-in trial (``python -m
  deepspeed_tpu_torch.autotuning.trial --device cpu``): the pruned
  candidates never launch, at least three trials score from their
  ``EFFICIENCY.json``, a trial wedged at ``train.step`` is reaped degraded
  while the search goes on, the baseline's two injected 3 s delays are
  booked to ``hang``, the verification run is scored with no hang, and
  ``tools/autotune_report.py`` gates the manifest.

Nothing here compares the speed of two subprocesses: which trial wins
under host load is not asserted, only that the artifacts name the one the
recorded numbers make the winner.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from deepspeed_tpu_torch.autotuning.loop import ClosedLoopAutotuner
from deepspeed_tpu_torch.autotuning.scheduler import DEGRADED, TrialScheduler

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_autotune_worker.py"
CHILD_ENV = {"PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
             "OMP_NUM_THREADS": "1"}
TRIAL_CMD = [sys.executable, "-m", "deepspeed_tpu_torch.autotuning.trial", "--device", "cpu"]


def _gone(pid, timeout_s=8.0):
    """True once ``pid`` has left the process table (a zombie keeps its
    /proc entry until reaped)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not os.path.exists(f"/proc/{pid}"):
            return True
        time.sleep(0.05)
    return not os.path.exists(f"/proc/{pid}")


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


# --------------------------------------------------------------------------- #
# the scheduler's lifecycle
# --------------------------------------------------------------------------- #
def test_sigterm_ignoring_group_is_fully_reaped(tmp_path):
    script = _script(tmp_path, "wedge.py", """
        import os, signal, subprocess, sys, time
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        trial_dir = os.path.dirname(os.environ["DS_AUTOTUNING_CONFIG"])
        with open(os.path.join(trial_dir, "leader.pid"), "w") as f:
            f.write(str(os.getpid()))
        code = ("import os, signal, time;"
                "signal.signal(signal.SIGTERM, signal.SIG_IGN);"
                "open(os.environ['GC_PID_FILE'], 'w').write(str(os.getpid()));"
                "time.sleep(120)")
        env = dict(os.environ, GC_PID_FILE=os.path.join(trial_dir, "grandchild.pid"))
        subprocess.Popen([sys.executable, "-c", code], env=env)
        time.sleep(120)
    """)
    sched = TrialScheduler(str(tmp_path / "trials"), cmd=[sys.executable, script],
                           timeout_s=2.0, reap_grace_s=0.5)
    t0 = time.monotonic()
    res = sched.run_trial("wedged", {})
    assert time.monotonic() - t0 < 30        # the deadline, not the 120 s sleep
    assert res.status == DEGRADED and res.timed_out and "deadline" in res.error
    trial_dir = Path(res.trial_dir)
    leader = int((trial_dir / "leader.pid").read_text())
    deadline = time.monotonic() + 10
    while not (trial_dir / "grandchild.pid").exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    grandchild = int((trial_dir / "grandchild.pid").read_text())
    assert _gone(leader), "the leader outlived the group reap"
    assert _gone(grandchild), "the grandchild outlived the group reap"
    with pytest.raises(ProcessLookupError):
        os.killpg(leader, 0)
    assert sched.status() == {"scored": 0, "degraded": 1, "running": 0}


def test_crashed_trial_is_degraded_not_dropped(tmp_path):
    script = _script(tmp_path, "crash.py", "import sys\nsys.exit(3)\n")
    sched = TrialScheduler(str(tmp_path / "trials"), cmd=[sys.executable, script],
                           timeout_s=30)
    res = sched.run_trial("crasher", {}, knobs={"zero_stage": 3})
    assert res.status == DEGRADED and res.rc == 3 and "rc=3" in res.error
    assert [r.name for r in sched.results] == ["crasher"]
    assert sched.results[0].knobs == {"zero_stage": 3}
    assert sched.status()["degraded"] == 1


# --------------------------------------------------------------------------- #
# the launcher's --autotuning
# --------------------------------------------------------------------------- #
RUNNER_CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
              "steps_per_print": 3,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "autotuning": {"zero_stages": [0], "micro_batch_sizes": [2, 4]}}


def _worker_lines(text):
    return [json.loads(x[len("WORKER "):]) for x in text.splitlines()
            if x.startswith("WORKER ")]


@pytest.mark.parametrize("mode", ["tune", "run"])
def test_runner_autotuning(tmp_path, mode):
    (tmp_path / "ds.json").write_text(json.dumps(RUNNER_CFG))
    env = dict(os.environ, **CHILD_ENV)
    env.pop("DS_AUTOTUNING_CONFIG", None)
    env.pop("DS_AUTOTUNING_METRIC_PATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", "--autotuning", mode,
         str(WORKER), "--device", "cpu", "--preset", "tiny", "--deepspeed_config", "ds.json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    exps = sorted((tmp_path / "autotuning_exps").iterdir())
    assert [e.name for e in exps] == ["z0_mbs2_0", "z0_mbs4_1"]
    recorded = {}
    for e in exps:
        metrics = json.loads((e / "metrics.json").read_text())
        assert metrics["global_steps"] == 6 and metrics["throughput"] > 0
        cfg = json.loads((e / "ds_config.json").read_text())
        assert "autotuning" not in cfg
        (line,) = _worker_lines((e / "stdout.log").read_text())
        assert line["micro_batch"] == cfg["train_micro_batch_size_per_gpu"]
        assert json.loads((e / "launches.json").read_text()) == line
        recorded[e.name] = (metrics["throughput"], cfg)
    best = max(recorded.values(), key=lambda v: v[0])
    optimal = json.loads((tmp_path / "autotuning_results" / "ds_config_optimal.json")
                         .read_text())
    assert optimal == best[1]
    summary = (tmp_path / "autotuning_results" / "summary.txt").read_text()
    assert f"best throughput: {best[0]}" in summary
    final = _worker_lines(out.stdout)
    if mode == "tune":
        assert final == []
    else:
        (line,) = final
        assert line["micro_batch"] == optimal["train_micro_batch_size_per_gpu"]
        assert line["steps"] == 6 and line["zero_stage"] == 0


# --------------------------------------------------------------------------- #
# the closed loop with the built-in trial
# --------------------------------------------------------------------------- #
WEDGE_PLAN = json.dumps([{"site": "train.step", "action": "wedge", "on_hit": 1}])
DELAY_S, HANG_THRESHOLD_S = 3.0, 1.0
BASELINE_PLAN = json.dumps([{"site": "train.step", "action": "delay", "delay_s": DELAY_S,
                             "on_hit": 1, "times": 2}])
P, BLOCK = 1_000_000, 700_000              # the pruning model's parameters


class FaultPlanScheduler(TrialScheduler):
    """The scheduler with per-trial fault plans: the wedged candidate gets
    the wedge plan and a short deadline, the baseline the delay plan."""

    wedge_cid = None
    wedge_timeout_s = 10.0

    def run_trial(self, name, ds_config, extra_env=None, **kw):
        extra_env = dict(extra_env or {})
        if name == "baseline":
            extra_env["DS_FAULT_PLAN"] = BASELINE_PLAN
        if name == self.wedge_cid:
            extra_env["DS_FAULT_PLAN"] = WEDGE_PLAN
            saved, self.timeout_s = self.timeout_s, self.wedge_timeout_s
            try:
                return super().run_trial(name, ds_config, extra_env=extra_env, **kw)
            finally:
                self.timeout_s = saved
        return super().run_trial(name, ds_config, extra_env=extra_env, **kw)


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    """ZeRO-3 with ``offload_param`` off or on, four micro-batches: the
    budget lies between the offloaded layer-window peak and the gathered
    peak, so the four unoffloaded candidates are pruned; of the four that
    run, the first is wedged."""
    from deepspeed_tpu_torch.runtime import memory_model
    root = tmp_path_factory.mktemp("autotune_e2e")
    results = root / "results"
    peaks = memory_model.analytic_step_peaks(P, 1, block_params=BLOCK, n_layer=12)
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "telemetry": {"enabled": True, "goodput": True, "watchdog_enabled": True,
                         "watchdog_timeout_s": HANG_THRESHOLD_S,
                         "flight_recorder_dir": str(root / "flight")},
           "autotuning": {"search_space": {"zero_stage": [3], "offload_param": [None, "cpu"],
                                           "micro_batch": [1, 2, 4, 8]},
                          "model_info": {"num_params": P, "n_layer": 12, "block_params": BLOCK},
                          "device_memory_bytes": (peaks.window_peak_bytes
                                                  + peaks.plain_peak_bytes) // 2,
                          "trial": {"steps": 4, "hidden_dim": 16},
                          "results_dir": str(results)}}
    sched = FaultPlanScheduler(str(results / "trials"), cmd=TRIAL_CMD, timeout_s=120.0,
                               reap_grace_s=2.0, env=CHILD_ENV)
    loop = ClosedLoopAutotuner(cfg, scheduler=sched, world=1)
    runnable = [c for c in loop.space.enumerate() if loop.prune_reason(c) is None]
    assert len(runnable) == 4
    sched.wedge_cid = runnable[0].cid
    best = loop.tune(baseline=True)
    verification = loop.verify()
    return loop, sched, best, verification, results


def _ledger(trial):
    return json.loads(Path(trial.efficiency_path).read_text())["ledger"]


def test_pruned_candidates_never_launch(tuned):
    loop, sched, *_, results = tuned
    assert len(loop.pruned) == 4
    launched = {r.name for r in sched.results}
    for row in loop.pruned:
        assert "offload_param" not in row.knobs
        assert "stage 3 gathered peak" in row.prune_reason
        assert row.name not in launched
        assert not (results / "trials" / row.name).exists()


def test_trials_scored_from_their_ledgers(tuned):
    loop, *_ = tuned
    scored = [t for t in loop.trials if t.scored]
    assert len(scored) >= 3
    for t in scored:
        led = _ledger(t)
        assert led["conservation"]["ok"] is True
        assert t.score.goodput_frac == led["goodput_frac"] and t.score.steps == led["steps"] == 4
        assert t.score.mfu is None and t.knobs["offload_param"] == "cpu"


def test_wedged_trial_reaped_and_search_continued(tuned):
    loop, sched, *_ = tuned
    wedged = next(t for t in loop.trials if t.name == sched.wedge_cid)
    assert wedged.status == DEGRADED and wedged.timed_out and "deadline" in wedged.error
    after = loop.trials[loop.trials.index(wedged) + 1:]
    assert len(after) == 3 and all(t.scored for t in after)
    assert sched.status()["running"] == 0


def test_baseline_delays_are_booked_to_hang(tuned):
    """Each delayed step's span exceeds the watchdog threshold by at least
    the delay less the threshold, which the ledger books to ``hang``."""
    loop, _, best, verification, _ = tuned
    assert loop.baseline.scored and verification.scored
    hang = _ledger(loop.baseline)["categories"]["hang"]
    assert hang >= 2 * (DELAY_S - HANG_THRESHOLD_S)
    assert _ledger(verification)["categories"].get("hang", 0.0) == 0.0
    assert verification.patch == best.patch


def test_artifacts_and_report(tuned, tmp_path):
    loop, _, best, _, results = tuned
    doc = json.loads((results / "ds_config_patch.json").read_text())
    assert doc["patch"] == best.patch and doc["provenance"]["trial"] == best.name
    assert doc["fingerprint"]["model"] == {"num_params": P, "n_layer": 12, "block_params": BLOCK}
    assert doc["fingerprint"]["pod"]["platform"] in ("cpu", "gpu")
    man = json.loads((results / "manifest.json").read_text())
    assert man["counts"] == {"candidates": 8, "pruned": 4, "run": 4,
                             "scored": man["counts"]["scored"], "degraded": 1}
    assert man["counts"]["scored"] == 3
    spec = importlib.util.spec_from_file_location("autotune_report",
                                                  REPO / "tools" / "autotune_report.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "report.json"
    assert tool.main([str(results), "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["gates"]["has_scored_best"]["ok"] is True and rep["counts"]["pruned"] == 4
    assert len(rep["leaderboard"]) == 3 and "micro_batch" in rep["knob_marginals"]
    assert tool.main([str(results), "--min-goodput-frac", "1.01"]) == 1
