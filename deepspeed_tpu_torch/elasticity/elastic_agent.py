"""Elastic training agent: worker supervision + membership-change restart
(the port's own copy of ``deepspeed_tpu/elasticity/elastic_agent.py``).

Reference: ``deepspeed/elasticity/elastic_agent.py:28`` (``DSElasticAgent``
subclasses torch-elastic's ``LocalElasticAgent``: monitors workers,
restarts the group on failure/membership change, propagates env).

As in the JAX package there is no torch-elastic rendezvous: the agent
supervises the worker processes the launcher spawns (one a GPU,
``launcher/launch.py``), and on a worker failure or a resource-set change
it kills the group and relaunches with a batch configuration re-solved by
the elasticity solver (``elasticity.compute_elastic_config``) for the new
world size, through ``DS_ELASTIC_TRAIN_BATCH`` / ``DS_ELASTIC_MICRO_BATCH``,
which ``deepspeed_tpu_torch.initialize`` applies; resumable checkpoints
carry the state.  Standard library only.
"""

import os
import random
import signal
import subprocess
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.comm.recovery import (RECOVERY_EXIT_CODES,
                                         RENDEZVOUS_DIR_ENV,
                                         consume_recovery_marker)
from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config
from deepspeed_tpu_torch.runtime.fault_tolerance import (PREEMPTION_EXIT_CODES,
                                                   backoff_delay)
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class WorkerSpec:
    """What to run on each (re)start: argv template + env.

    ``cmd`` may be a list (fixed argv) or a callable returning the argv —
    callables receive the restart's full env dict (so launchers that bake
    env exports into the command, pdsh/mpirun, pick up the re-solved batch
    config and the live host set) and are invoked per (re)start."""

    def __init__(self, cmd, env: Optional[Dict[str, str]] = None):
        self.cmd = cmd
        self.env = dict(env or {})

    def argv(self, env: Optional[Dict[str, str]] = None) -> List[str]:
        if callable(self.cmd):
            import inspect
            params = inspect.signature(self.cmd).parameters
            return list(self.cmd(env or {}) if params else self.cmd())
        return list(self.cmd)


class DSElasticAgent:

    def __init__(self, spec: WorkerSpec, ds_config: Optional[Dict] = None,
                 max_restarts: int = 3, monitor_interval: float = 1.0,
                 world_size_fn: Optional[Callable[[], int]] = None,
                 telemetry=None,
                 restart_backoff_s: float = 1.0,
                 restart_backoff_max_s: float = 30.0,
                 restart_jitter: float = 0.2,
                 stability_window_s: float = 300.0,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        """``world_size_fn`` reports the currently-available world size
        (hostfile / scheduler probe); a change triggers a restart with
        a re-solved elastic batch config.  ``telemetry`` (a TelemetryHub)
        receives a structured ``worker_exit`` record for every worker-group
        exit — failure, membership change, clean finish, or give-up — so
        restarts leave an audit trail instead of happening silently.

        Restart hygiene: crash restarts back off exponentially
        (``restart_backoff_s`` → ``restart_backoff_max_s``, ±``restart_jitter``
        relative noise against stampedes), and a group that stayed up for
        ``stability_window_s`` seconds resets the restart budget — a crash
        every few hours must not accumulate toward give-up forever.
        Workers exiting with the preemption code (143 / -SIGTERM) restart
        immediately without touching the budget: the scheduler took the
        machine, the program did nothing wrong.  Coordinator-confirmed
        recovery exits (reserved codes 113/114, or SIGKILL with a fresh
        rendezvous marker — see :meth:`_recovery_exit_cause`) are treated
        the same way.  The knobs are overridable
        via the ``fault_tolerance`` block of ``ds_config``.  ``sleep_fn``
        and ``rng`` are injectable so tests never wall-clock sleep."""
        self.spec = spec
        self.ds_config = ds_config or {}
        ftc = self.ds_config.get("fault_tolerance", {})
        self.max_restarts = max_restarts
        self.monitor_interval = monitor_interval
        self.world_size_fn = world_size_fn or (lambda: 1)
        self.telemetry = telemetry
        self.restart_backoff_s = float(
            ftc.get("restart_backoff_s", restart_backoff_s))
        self.restart_backoff_max_s = float(
            ftc.get("restart_backoff_max_s", restart_backoff_max_s))
        self.restart_jitter = float(ftc.get("restart_jitter", restart_jitter))
        self.stability_window_s = float(
            ftc.get("stability_window_s", stability_window_s))
        self._sleep = sleep_fn
        self._rng = rng
        self.restart_count = 0
        self.preemption_count = 0
        self.recovery_count = 0
        self._proc: Optional[subprocess.Popen] = None
        self._world = None
        self._start_t: Optional[float] = None
        self._last_backoff_s = 0.0

    def _emit_worker_exit(self, exit_code, reason: str):
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit("worker_exit", {
                "exit_code": exit_code,
                "reason": reason,
                "restart_count": self.restart_count,
                "preemption_count": self.preemption_count,
                "uptime_s": (time.monotonic() - self._start_t
                             if self._start_t is not None else None),
                "backoff_s": self._last_backoff_s,
                "world_size": self._world,
                "pid": self._proc.pid if self._proc is not None else None,
            })
            self.telemetry.flush()
        except Exception as e:
            logger.warning(f"elastic agent: worker_exit emission failed: {e}")

    def _emit_downtime(self, t_down: float, reason: str, exit_code):
        """Structured ``downtime`` record: the worker_exit→restart gap
        (detection + reap + backoff + relaunch), the raw material for the
        goodput ledger's cross-attempt ``downtime`` category
        (``telemetry/ledger.py:fold_goodput``)."""
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit("downtime", {
                "downtime_s": time.monotonic() - t_down,
                "backoff_s": self._last_backoff_s,
                "reason": reason,
                "exit_code": exit_code,
                "restart_count": self.restart_count,
                "preemption_count": self.preemption_count,
                "world_size": self._world,
            })
            self.telemetry.flush()
        except Exception as e:
            logger.warning(f"elastic agent: downtime emission failed: {e}")

    def _recovery_exit_cause(self, rc) -> Optional[str]:
        """Classify a worker exit as a coordinator-directed recovery exit.

        Two confirmation paths, mirroring the recovery ladder's two ways
        of retiring a process (``comm/recovery.py``):

        * reserved exit codes (113 restart rung / 114 mesh-shrink
          exclusion) are self-describing — the marker, when present,
          only refines the cause string;
        * ``SIGKILL`` (rc ``-9``) is ambiguous (OOM killer kills the same
          way), so it counts as recovery **only** when the coordinator
          left a fresh ``recovery_exit.json`` marker in the rendezvous
          dir — coordinator-confirmed, per the abort protocol.

        Returns the cause string, or None for an ordinary failure."""
        if rc not in RECOVERY_EXIT_CODES and rc != -signal.SIGKILL:
            return None   # don't burn the one-shot marker on other exits
        rdv_dir = (self.spec.env.get(RENDEZVOUS_DIR_ENV)
                   or os.environ.get(RENDEZVOUS_DIR_ENV))
        marker = (consume_recovery_marker(rdv_dir)
                  if rdv_dir else None)
        if rc in RECOVERY_EXIT_CODES:
            cause = (marker or {}).get("cause") or (
                "mesh_shrink" if rc == RECOVERY_EXIT_CODES[1] else "restart")
            return cause
        if rc == -signal.SIGKILL and marker is not None:
            return (marker.get("cause") or "rank_killed")
        return None

    # ------------------------------------------------------------------ #
    def _elastic_env(self, world: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.spec.env)
        env["DS_ELASTIC_WORLD_SIZE"] = str(world)
        if self.ds_config.get("elasticity", {}).get("enabled", False):
            batch, _valid, micro = compute_elastic_config(
                self.ds_config, "0.0", world_size=world,
                return_microbatch=True)
            env["DS_ELASTIC_TRAIN_BATCH"] = str(batch)
            env["DS_ELASTIC_MICRO_BATCH"] = str(micro)
            log_dist(f"elastic agent: world={world} -> train_batch={batch}, "
                     f"micro={micro}", ranks=[0])
        return env

    def _start(self, world: int):
        self._world = world
        env = self._elastic_env(world)
        self._proc = subprocess.Popen(self.spec.argv(env), env=env,
                                      start_new_session=True)
        self._start_t = time.monotonic()
        log_dist(f"elastic agent: started workers (pid {self._proc.pid}, "
                 f"world {world})", ranks=[0])

    def _stop(self, reason: str = "stop", timeout: float = 15.0):
        """Terminate and REAP the whole worker process group, then emit a
        structured ``worker_exit`` record.  Returns the group leader's
        exit code (None if it had already been collected).

        Reaping matters: the launcher's children share the leader's
        process group (``start_new_session=True``), and without an
        explicit ``waitpid`` sweep over ``-pgid`` they linger as zombies
        across restarts until the agent itself exits."""
        if self._proc is None:
            return None
        rc = self._proc.poll()
        try:
            pgid = os.getpgid(self._proc.pid)
        except ProcessLookupError:
            pgid = self._proc.pid
        if rc is None:
            try:   # kill the whole process group (launcher children incl.)
                os.killpg(pgid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                rc = self._proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(pgid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                rc = self._proc.wait()
        # sweep the rest of the group (scoped to -pgid: never steal other
        # children of this process)
        while True:
            try:
                pid, _status = os.waitpid(-pgid, os.WNOHANG)
            except ChildProcessError:
                break
            except OSError:
                break
            if pid == 0:
                break
        self._emit_worker_exit(rc, reason)
        return rc

    # ------------------------------------------------------------------ #
    def run(self, max_steps: Optional[int] = None) -> int:
        """Supervise until the workers exit cleanly, restarts are
        exhausted, or ``max_steps`` monitor ticks pass (testing hook).
        Returns the final exit code."""
        self._start(self.world_size_fn())
        ticks = 0
        while True:
            time.sleep(self.monitor_interval)
            ticks += 1
            rc = self._proc.poll()
            if rc is not None:
                # leader already exited — _stop degrades to reap-and-emit
                if rc == 0:
                    log_dist("elastic agent: workers finished", ranks=[0])
                    self._stop(reason="clean_exit")
                    return 0
                uptime = (time.monotonic() - self._start_t
                          if self._start_t is not None else 0.0)
                recovery_cause = self._recovery_exit_cause(rc)
                if recovery_cause is not None:
                    # the recovery coordinator retired this group on
                    # purpose (ladder rung exit or confirmed rank kill):
                    # like a preemption, the program did nothing wrong —
                    # restart now, burn no crash budget
                    self.recovery_count += 1
                    self._last_backoff_s = 0.0
                    log_dist(f"elastic agent: recovery exit (rc={rc}, "
                             f"cause={recovery_cause}, uptime "
                             f"{uptime:.1f}s) — restarting immediately",
                             ranks=[0])
                    t_down = time.monotonic()
                    self._stop(reason=f"recovery:{recovery_cause}")
                    self._start(self.world_size_fn())
                    self._emit_downtime(
                        t_down, f"recovery:{recovery_cause}", rc)
                    continue
                if rc in PREEMPTION_EXIT_CODES:
                    # the scheduler reclaimed the machine, not a bug:
                    # restart now, leave the crash budget untouched
                    self.preemption_count += 1
                    self._last_backoff_s = 0.0
                    log_dist(f"elastic agent: workers preempted (rc={rc}, "
                             f"uptime {uptime:.1f}s) — restarting "
                             f"immediately", ranks=[0])
                    t_down = time.monotonic()
                    self._stop(reason="preemption")
                    self._start(self.world_size_fn())
                    self._emit_downtime(t_down, "preemption", rc)
                    continue
                if uptime >= self.stability_window_s and self.restart_count:
                    # the group ran long enough to call the previous
                    # failures transient — the budget regenerates
                    log_dist(f"elastic agent: {uptime:.0f}s of stable uptime; "
                             f"resetting restart budget", ranks=[0])
                    self.restart_count = 0
                if self.restart_count >= self.max_restarts:
                    logger.error(f"elastic agent: giving up after "
                                 f"{self.restart_count} restarts (rc={rc})")
                    self._stop(reason="max_restarts_exceeded")
                    return rc
                self.restart_count += 1
                self._last_backoff_s = backoff_delay(
                    self.restart_count, self.restart_backoff_s,
                    self.restart_backoff_max_s, self.restart_jitter,
                    rng=self._rng)
                log_dist(f"elastic agent: worker failure rc={rc} — restart "
                         f"{self.restart_count}/{self.max_restarts} in "
                         f"{self._last_backoff_s:.2f}s", ranks=[0])
                t_down = time.monotonic()
                self._stop(reason="worker_failure")
                self._sleep(self._last_backoff_s)
                self._start(self.world_size_fn())
                self._emit_downtime(t_down, "worker_failure", rc)
                continue
            world = self.world_size_fn()
            if world != self._world:
                # membership change (preemption / scale-up): restart with a
                # re-solved batch config; checkpoints reshard on resume
                log_dist(f"elastic agent: membership {self._world} -> {world}; "
                         f"restarting", ranks=[0])
                t_down = time.monotonic()
                old_world = self._world
                self._last_backoff_s = 0.0
                self._stop(reason=f"membership_change:{old_world}->{world}")
                self._start(world)
                self._emit_downtime(
                    t_down, f"membership_change:{old_world}->{world}", rc)
            if max_steps is not None and ticks >= max_steps:
                self._stop(reason="max_steps")
                return 0
