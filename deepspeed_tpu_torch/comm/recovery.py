"""Out-of-band recovery control plane: heartbeats, coordinated abort,
and the policy ladder (retry → elastic mesh shrink → full restart).  The
port's own copy of ``deepspeed_tpu/comm/recovery.py``, with its wire
format: rendezvous files and recovery markers written by either package
are read by the other.

When a collective wedges or a rank dies, the one channel guaranteed
broken is the process group itself — so everything here runs host-side
over a tiny shared-filesystem rendezvous (atomic file creates and
renames; the same durability primitives the checkpoint layer trusts).
No device communication anywhere in this module.

The pieces:

* :class:`RecoveryPolicy` — parsed from the ``ds_config["elasticity"]``
  block (coexists with the elastic batch-solver keys; recovery is gated
  on its own ``recovery_enabled``).  Owns the ladder decision:
  ``next_rung`` maps (attempt, survivors, world) to ``retry`` (transient
  straggler, everyone still alive), ``shrink`` (a rank died and the
  survivor set can rebuild a smaller mesh), or ``restart`` (final rung —
  hand the incident to the elastic agent).

* :class:`FileRendezvous` — the wire format: per-rank membership and
  heartbeat files (atomic replace), a first-writer-wins abort file per
  epoch (atomic ``O_EXCL`` create), per-rank abort acks (the barrier
  that gets every survivor out of the captured step at the same step
  boundary), and a leader-published recovery plan.

* :class:`RecoveryCoordinator` — the per-rank agent over the
  rendezvous: a background heartbeat thread, liveness detection (pid
  probe for same-host ranks — a SIGKILLed rank is visible in one poll,
  long before its heartbeat ages out), abort signal/ack/await, and
  leader plan election (lowest acked rank decides).

* :class:`RecoveryManager` — the engine-facing ladder state machine:
  incident bookkeeping, ``collective_abort``/``mesh_shrink``/
  ``recovery_*`` telemetry, the ``/recovery`` ops-endpoint payload, the
  ``/healthz`` latch, and the ``comm_recovery`` goodput booking.  The
  engine owns the actual state rebuild (retrace, re-shard, reload) —
  this module only coordinates it.

Exit protocol: ranks leaving for recovery reasons use dedicated exit
codes (:data:`MESH_SHRINK_EXIT_CODE` for survivors excluded by a shrink
plan, :data:`RECOVERY_RESTART_EXIT_CODE` for the final rung) and drop a
coordinator-confirmed marker (:func:`write_recovery_marker`) that the
elastic agent consumes to classify the exit like a preemption —
immediate restart, no restart-budget burn — even when the raw exit was
a SIGKILL (-9).

Standard library only.
"""

import json
import os
import socket
import threading
import time

SCHEMA_VERSION = 1

#: a survivor excluded by a shrink plan exits with this code
MESH_SHRINK_EXIT_CODE = 114
#: the final ladder rung (coordinated full restart) exits with this code
RECOVERY_RESTART_EXIT_CODE = 113
#: every coordinator-confirmed recovery exit code
RECOVERY_EXIT_CODES = (RECOVERY_RESTART_EXIT_CODE, MESH_SHRINK_EXIT_CODE)

#: env fallbacks for rendezvous identity (the e2e harness sets these)
RENDEZVOUS_DIR_ENV = "DS_RECOVERY_DIR"
RANK_ENV = "DS_RECOVERY_RANK"
WORLD_ENV = "DS_RECOVERY_WORLD"

_MARKER_NAME = "recovery_exit.json"


# --------------------------------------------------------------------------- #
# Policy
# --------------------------------------------------------------------------- #

class RecoveryPolicy:
    """The ``elasticity`` recovery keys, with the ladder decision.

    Keys (all under ``ds_config["elasticity"]``, ignored by the elastic
    batch solver which only reads its own keys):

    ``recovery_enabled``        master gate (default False)
    ``collective_timeout_s``    bounded-collective deadline (30.0)
    ``heartbeat_interval_s``    heartbeat write cadence (0.5)
    ``heartbeat_timeout_s``     heartbeat age ⇒ rank presumed dead (5.0)
    ``max_step_retries``        retry-rung attempts before escalating (2)
    ``retry_backoff_s``         base backoff between retries (0.5)
    ``min_world_size``          smallest mesh a shrink may target (1)
    ``allow_shrink``            enable the shrink rung (True)
    ``allow_restart``           enable the final restart rung (True)
    ``recovery_deadline_s``     end-to-end detect→resume bound (120.0)
    ``rendezvous_dir``          shared dir (or env ``DS_RECOVERY_DIR``)
    """

    def __init__(self, enabled=False, collective_timeout_s=30.0,
                 heartbeat_interval_s=0.5, heartbeat_timeout_s=5.0,
                 max_step_retries=2, retry_backoff_s=0.5, min_world_size=1,
                 allow_shrink=True, allow_restart=True,
                 recovery_deadline_s=120.0, rendezvous_dir=None):
        self.enabled = bool(enabled)
        self.collective_timeout_s = float(collective_timeout_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.min_world_size = int(min_world_size)
        self.allow_shrink = bool(allow_shrink)
        self.allow_restart = bool(allow_restart)
        self.recovery_deadline_s = float(recovery_deadline_s)
        self.rendezvous_dir = rendezvous_dir or os.environ.get(
            RENDEZVOUS_DIR_ENV) or None

    @classmethod
    def from_config(cls, ds_config):
        """Parse the ``elasticity`` block of a ds_config dict (or a
        config object exposing ``elasticity_config``)."""
        if ds_config is None:
            block = {}
        elif isinstance(ds_config, dict):
            block = ds_config.get("elasticity", {}) or {}
        else:
            block = getattr(ds_config, "elasticity_config", {}) or {}
        return cls(
            enabled=block.get("recovery_enabled", False),
            collective_timeout_s=block.get("collective_timeout_s", 30.0),
            heartbeat_interval_s=block.get("heartbeat_interval_s", 0.5),
            heartbeat_timeout_s=block.get("heartbeat_timeout_s", 5.0),
            max_step_retries=block.get("max_step_retries", 2),
            retry_backoff_s=block.get("retry_backoff_s", 0.5),
            min_world_size=block.get("min_world_size", 1),
            allow_shrink=block.get("allow_shrink", True),
            allow_restart=block.get("allow_restart", True),
            recovery_deadline_s=block.get("recovery_deadline_s", 120.0),
            rendezvous_dir=block.get("rendezvous_dir"))

    # -- ladder -------------------------------------------------------------- #

    def shrink_target(self, n_survivors):
        """Largest power-of-two world ≤ the survivor count that stays at
        or above ``min_world_size`` — None when no legal target exists.
        Power-of-two keeps every mesh-axis factorization legal without
        re-solving the axis split here."""
        n = int(n_survivors)
        if n < max(self.min_world_size, 1):
            return None
        target = 1
        while target * 2 <= n:
            target *= 2
        if target < self.min_world_size:
            return None
        return target

    def next_rung(self, attempt, n_survivors, world_size):
        """The ladder decision for one incident iteration.

        * everyone alive + retries left → ``retry`` (transient wedge)
        * ranks missing (or retries exhausted with a legal smaller mesh
          unavailable ruled out) → ``shrink`` when allowed and feasible
        * otherwise → ``restart`` when allowed, else ``fail``
        """
        all_alive = int(n_survivors) >= int(world_size)
        if all_alive and attempt < self.max_step_retries:
            return "retry"
        if not all_alive and self.allow_shrink:
            target = self.shrink_target(n_survivors)
            if target is not None and target < int(world_size):
                return "shrink"
        if self.allow_restart:
            return "restart"
        return "fail"

    def retry_delay_s(self, attempt):
        """Exponential backoff for the retry rung (attempt is 0-based)."""
        return self.retry_backoff_s * (2.0 ** max(int(attempt), 0))

    def to_json(self):
        return {
            "enabled": self.enabled,
            "collective_timeout_s": self.collective_timeout_s,
            "heartbeat_interval_s": self.heartbeat_interval_s,
            "heartbeat_timeout_s": self.heartbeat_timeout_s,
            "max_step_retries": self.max_step_retries,
            "retry_backoff_s": self.retry_backoff_s,
            "min_world_size": self.min_world_size,
            "allow_shrink": self.allow_shrink,
            "allow_restart": self.allow_restart,
            "recovery_deadline_s": self.recovery_deadline_s,
            "rendezvous_dir": self.rendezvous_dir,
        }


def resolve_rank_world(default_world=1):
    """(rank, world) for the coordinator, from the recovery env with the
    launcher envs as fallback — single-process runs resolve to (0, 1)."""
    rank = int(os.environ.get(RANK_ENV, os.environ.get("RANK", "0")) or 0)
    world = int(os.environ.get(
        WORLD_ENV, os.environ.get("WORLD_SIZE", str(default_world)))
        or default_world)
    return rank, max(world, 1)


# --------------------------------------------------------------------------- #
# File rendezvous — the wire format
# --------------------------------------------------------------------------- #

def _write_json_atomic(path, doc):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class FileRendezvous:
    """Shared-directory rendezvous: every primitive is an atomic file
    create or replace, so partial writes are never observable.  One
    instance per rank; no locks — each rank writes only its own files,
    except the first-writer-wins abort/plan files which use ``O_EXCL``.
    """

    def __init__(self, root, rank, world_size, clock=time.time):
        self.root = str(root)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._clock = clock
        os.makedirs(os.path.join(self.root, "members"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "hb"), exist_ok=True)

    # -- membership ---------------------------------------------------------- #

    def announce(self):
        _write_json_atomic(
            os.path.join(self.root, "members", "rank_%d.json" % self.rank),
            {"rank": self.rank, "pid": os.getpid(),
             "host": socket.gethostname(), "t": self._clock()})

    def members(self):
        """rank → membership doc for every announced rank."""
        out = {}
        mdir = os.path.join(self.root, "members")
        try:
            names = os.listdir(mdir)
        except OSError:
            return out
        for name in names:
            if not name.startswith("rank_") or not name.endswith(".json"):
                continue
            doc = _read_json(os.path.join(mdir, name))
            if doc is not None:
                out[int(doc["rank"])] = doc
        return out

    # -- heartbeats ----------------------------------------------------------- #

    def heartbeat(self, step=0, epoch=0):
        _write_json_atomic(
            os.path.join(self.root, "hb", "rank_%d.json" % self.rank),
            {"rank": self.rank, "pid": os.getpid(),
             "host": socket.gethostname(), "t": self._clock(),
             "step": int(step), "epoch": int(epoch)})

    def heartbeats(self):
        out = {}
        hdir = os.path.join(self.root, "hb")
        try:
            names = os.listdir(hdir)
        except OSError:
            return out
        for name in names:
            doc = _read_json(os.path.join(hdir, name))
            if doc is not None:
                out[int(doc["rank"])] = doc
        return out

    # -- abort (first writer wins) ------------------------------------------- #

    def signal_abort(self, epoch, payload):
        """Atomically create the epoch's abort file.  Returns
        ``(doc, won)``: the winning doc (ours or the earlier writer's)
        and whether this rank won the race."""
        path = os.path.join(self.root, "abort_%d.json" % int(epoch))
        doc = dict(payload)
        doc.setdefault("epoch", int(epoch))
        doc.setdefault("rank", self.rank)
        doc.setdefault("t", self._clock())
        try:
            fd = os.open(path + ".lock", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            existing = self._await_file(path)
            return (existing if existing is not None else doc), False
        try:
            _write_json_atomic(path, doc)
        finally:
            os.close(fd)
        return doc, True

    def read_abort(self, epoch):
        return _read_json(
            os.path.join(self.root, "abort_%d.json" % int(epoch)))

    def _await_file(self, path, timeout_s=5.0, poll_s=0.02):
        """The ``.lock`` exists but the doc may still be mid-write on the
        winner — wait briefly for it to land."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            doc = _read_json(path)
            if doc is not None:
                return doc
            time.sleep(poll_s)
        return _read_json(path)

    # -- abort-ack barrier ----------------------------------------------------- #

    def ack_abort(self, epoch, info=None):
        _write_json_atomic(
            os.path.join(self.root,
                         "ack_%d_rank_%d.json" % (int(epoch), self.rank)),
            dict(info or {}, rank=self.rank, epoch=int(epoch),
                 t=self._clock()))

    def acks(self, epoch):
        """Ranks that have acked this epoch's abort."""
        out = set()
        prefix = "ack_%d_rank_" % int(epoch)
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if name.startswith(prefix) and name.endswith(".json"):
                try:
                    out.add(int(name[len(prefix):-len(".json")]))
                except ValueError:
                    pass
        return out

    # -- plan ------------------------------------------------------------------ #

    def publish_plan(self, epoch, plan):
        _write_json_atomic(
            os.path.join(self.root, "plan_%d.json" % int(epoch)), plan)

    def read_plan(self, epoch):
        return _read_json(
            os.path.join(self.root, "plan_%d.json" % int(epoch)))

    # -- quarantine ------------------------------------------------------------- #

    def write_quarantine(self, ranks, detail=None):
        doc = _read_json(os.path.join(self.root, "quarantine.json")) or {
            "schema": SCHEMA_VERSION, "ranks": [], "incidents": []}
        merged = sorted(set(doc.get("ranks", [])) | set(int(r) for r in ranks))
        doc["ranks"] = merged
        if detail:
            doc.setdefault("incidents", []).append(dict(detail))
        _write_json_atomic(os.path.join(self.root, "quarantine.json"), doc)
        return doc

    def read_quarantine(self):
        return _read_json(os.path.join(self.root, "quarantine.json"))


# --------------------------------------------------------------------------- #
# Per-rank coordinator
# --------------------------------------------------------------------------- #

class RecoveryCoordinator:
    """Heartbeat + abort agent for one rank.

    Thread model: a background daemon thread writes heartbeats at the
    policy cadence; all shared mutable state (`_step`, `_epoch`,
    `_world_size`) is guarded by ``_lock`` and copied out before any
    file I/O — the rendezvous writes never run under the lock.
    """

    def __init__(self, rendezvous, policy, clock=time.monotonic):
        self.rdv = rendezvous
        self.policy = policy
        self.rank = rendezvous.rank
        self._clock = clock
        self._lock = threading.Lock()
        self._step = 0                 # guarded-by: _lock
        self._epoch = 0                # guarded-by: _lock
        self._world_size = rendezvous.world_size   # guarded-by: _lock
        self._stop_event = threading.Event()
        self._thread = None

    # -- lifecycle ------------------------------------------------------------- #

    def start(self):
        self.rdv.announce()
        self.heartbeat_now()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._hb_loop, name="dst-recovery-hb", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop_event.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def _hb_loop(self):
        interval = max(self.policy.heartbeat_interval_s, 0.05)
        while not self._stop_event.wait(interval):
            try:
                self.heartbeat_now()
            except OSError:
                pass    # rendezvous dir raced with teardown; next tick retries

    def _snapshot(self):
        with self._lock:
            return self._step, self._epoch, self._world_size

    def heartbeat_now(self):
        step, epoch, _ = self._snapshot()
        self.rdv.heartbeat(step=step, epoch=epoch)

    # -- state feeds ------------------------------------------------------------ #

    def note_step(self, step):
        with self._lock:
            self._step = int(step)

    @property
    def epoch(self):
        with self._lock:
            return self._epoch

    @property
    def world_size(self):
        with self._lock:
            return self._world_size

    # -- liveness ---------------------------------------------------------------- #

    @staticmethod
    def _pid_alive(pid):
        try:
            os.kill(int(pid), 0)
        except ProcessLookupError:
            return False
        except (OSError, ValueError, TypeError):
            return True     # not ours to probe — fall back to heartbeat age
        # signal-0 succeeds on a zombie: a SIGKILLed rank whose parent
        # has not reaped it yet would probe alive forever.  Where /proc
        # exposes the state, a zombie counts as dead.
        try:
            with open(f"/proc/{int(pid)}/stat") as f:
                stat = f.read()
            return stat.rpartition(")")[2].split()[0] != "Z"
        except (OSError, IndexError):
            return True


    def live_ranks(self, now=None):
        """Ranks currently presumed alive: heartbeat fresh, or (same
        host) pid probe positive.  A SIGKILLed same-host rank fails the
        pid probe immediately — detection does not wait for the
        heartbeat to age out."""
        now = time.time() if now is None else now
        host = socket.gethostname()
        hbs = self.rdv.heartbeats()
        members = self.rdv.members()
        live = set()
        for rank in set(hbs) | set(members):
            doc = hbs.get(rank) or members.get(rank)
            same_host = doc.get("host") == host
            if same_host and not self._pid_alive(doc.get("pid", -1)):
                continue
            age = now - float(doc.get("t", 0.0))
            if same_host or age <= self.policy.heartbeat_timeout_s:
                live.add(rank)
        return sorted(live)

    def dead_ranks(self, now=None):
        """Ranks of the CURRENT mesh that look dead.  Ranks at or above
        the current world size are ignored — their rendezvous files are
        leftovers of a pre-shrink epoch (quarantined or excluded ranks),
        and flagging them would re-open the incident on every boundary."""
        world = self.world_size
        known = set(self.rdv.members()) | set(self.rdv.heartbeats())
        known = {r for r in known if r < world}
        return sorted(known - set(self.live_ranks(now=now)))

    # -- abort protocol ------------------------------------------------------------ #

    def request_abort(self, cause, detail=None):
        """Signal (or join) this epoch's coordinated abort.  First writer
        wins; everyone converges on the same abort doc."""
        step, epoch, _ = self._snapshot()
        doc, won = self.rdv.signal_abort(epoch, {
            "schema": SCHEMA_VERSION, "cause": str(cause),
            "detail": dict(detail or {}), "step": step})
        return doc, won

    def poll_abort(self):
        """The step-boundary check: this epoch's abort doc, or None."""
        return self.rdv.read_abort(self.epoch)

    def abort_barrier(self, deadline_s=None, poll_s=0.05):
        """Ack the abort and wait for every live rank's ack (bounded).
        Returns the sorted acked-rank set — the survivor candidates.
        Ranks that never ack within the deadline (dead or still wedged)
        are simply absent; the ladder decides what that means."""
        step, epoch, _ = self._snapshot()
        self.rdv.ack_abort(epoch, {"step": step})
        bound = (self.policy.recovery_deadline_s / 4.0
                 if deadline_s is None else deadline_s)
        deadline = self._clock() + max(bound, poll_s)
        world = self.world_size
        while self._clock() < deadline:
            acked = self.rdv.acks(epoch)
            live = {r for r in self.live_ranks() if r < world}
            if live and live <= acked:
                break
            time.sleep(poll_s)
        live = {r for r in self.live_ranks() if r < world}
        return sorted(self.rdv.acks(epoch) & live | {self.rank})

    # -- plan ------------------------------------------------------------------------ #

    def is_leader(self, survivors):
        return min(survivors) == self.rank if survivors else True

    def publish_plan(self, plan):
        epoch = self.epoch
        plan = dict(plan, epoch=epoch, leader=self.rank)
        self.rdv.publish_plan(epoch, plan)
        return plan

    def await_plan(self, deadline_s=None, poll_s=0.05):
        epoch = self.epoch
        bound = (self.policy.recovery_deadline_s / 2.0
                 if deadline_s is None else deadline_s)
        deadline = self._clock() + max(bound, poll_s)
        while self._clock() < deadline:
            plan = self.rdv.read_plan(epoch)
            if plan is not None:
                return plan
            time.sleep(poll_s)
        return self.rdv.read_plan(epoch)

    def advance_epoch(self, new_world_size=None):
        """Enter the next coordination epoch (after an incident resolves);
        stale abort/ack/plan files from the old epoch become inert."""
        with self._lock:
            self._epoch += 1
            if new_world_size is not None:
                self._world_size = int(new_world_size)
            epoch = self._epoch
        self.heartbeat_now()
        return epoch


# --------------------------------------------------------------------------- #
# Engine-facing ladder state machine
# --------------------------------------------------------------------------- #

#: /recovery ladder states
LADDER_STATES = ("idle", "aborting", "retry", "shrink", "restart",
                 "recovered", "failed")


class RecoveryManager:
    """Incident bookkeeping + telemetry + ops-plane surface.

    The engine calls :meth:`begin_incident` when a deadline fires (or a
    peer's abort is observed), then reports each rung via
    :meth:`note_rung` and the terminal outcome via :meth:`note_recovered`
    / :meth:`note_failed`.  Everything here is host bookkeeping — safe
    to call from the step boundary.
    """

    def __init__(self, policy, coordinator=None, telemetry=None,
                 ledger=None, clock=time.monotonic):
        self.policy = policy
        self.coordinator = coordinator
        self.telemetry = telemetry
        self.ledger = ledger
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "idle"           # guarded-by: _lock
        self._last_abort = None        # guarded-by: _lock
        self._incidents = 0            # guarded-by: _lock
        self._recoveries = 0           # guarded-by: _lock
        self._failed = False           # guarded-by: _lock
        self._incident_t0 = None       # guarded-by: _lock
        self._incident_booked = 0.0    # guarded-by: _lock
        self._last_recovery_s = None   # guarded-by: _lock
        self._quarantined = []         # guarded-by: _lock
        self._world_size = (coordinator.world_size
                            if coordinator is not None else 1)

    # -- telemetry plumbing ---------------------------------------------------- #

    def _emit(self, kind, payload):
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit(kind, payload)
            self.telemetry.flush()
        except Exception:
            pass

    # -- incident lifecycle ------------------------------------------------------ #

    def begin_incident(self, cause, detail=None, step=None, backdate_s=0.0):
        """An incident opened (deadline expiry, observed peer abort, or
        detected rank death).  Emits ``collective_abort`` and flips the
        ladder out of idle.  ``backdate_s`` shifts the incident clock
        into the past — a deadline expiry means the run was already
        wedged for the whole deadline, and that wait belongs to the
        incident, not to training.  Returns the incident record."""
        with self._lock:
            self._incidents += 1
            self._state = "aborting"
            self._incident_t0 = self._clock() - max(float(backdate_s), 0.0)
            self._incident_booked = 0.0
            incident = {
                "schema": SCHEMA_VERSION,
                "incident": self._incidents,
                "cause": str(cause),
                "detail": dict(detail or {}),
                "step": step,
            }
            self._last_abort = incident
        self._emit("collective_abort", dict(incident))
        return incident

    def note_rung(self, rung, attempt=0, detail=None):
        """One ladder rung is being executed."""
        with self._lock:
            self._state = rung
        payload = {"rung": rung, "attempt": int(attempt),
                   "detail": dict(detail or {})}
        kind = {"retry": "recovery_retry", "shrink": "mesh_shrink",
                "restart": "recovery_restart"}.get(rung, "recovery_rung")
        self._emit(kind, payload)

    def note_quarantined(self, ranks, detail=None):
        with self._lock:
            merged = sorted(set(self._quarantined) | set(int(r)
                                                         for r in ranks))
            self._quarantined = merged
        if self.coordinator is not None:
            try:
                self.coordinator.rdv.write_quarantine(ranks, detail=detail)
            except OSError:
                pass

    def note_world_size(self, world_size):
        with self._lock:
            self._world_size = int(world_size)

    def book_rung_complete(self):
        """Book the ladder time spent so far into the conserved
        ``comm_recovery`` ledger category.  The engine calls this the
        moment a rung finishes rebuilding — BEFORE the step re-runs —
        so the retried step's own wall time books as training, not
        recovery (the ledger attributes spans to whichever category
        advanced the mark last).  Incremental and idempotent across
        repeated rungs of one incident."""
        with self._lock:
            t0 = self._incident_t0
            if t0 is None:
                return 0.0
            elapsed = self._clock() - t0
            dt = max(elapsed - self._incident_booked, 0.0)
            self._incident_booked = elapsed
        if self.ledger is not None and dt > 0.0:
            try:
                self.ledger.note_comm_recovery(dt)
            except Exception:
                pass
        return dt

    def note_recovered(self, rung, detail=None):
        """The incident resolved (the step after the rung succeeded):
        emit ``recovery_resume`` with the end-to-end incident duration.
        Ledger booking happened per-rung via :meth:`book_rung_complete`;
        only if the engine never booked does the whole duration book
        here (fallback — never both)."""
        with self._lock:
            t0, self._incident_t0 = self._incident_t0, None
            booked, self._incident_booked = self._incident_booked, 0.0
            dt = (self._clock() - t0) if t0 is not None else 0.0
            self._state = "recovered"
            self._recoveries += 1
            self._last_recovery_s = dt
        if self.ledger is not None and booked == 0.0 and dt > 0.0:
            try:
                self.ledger.note_comm_recovery(dt)
            except Exception:
                pass
        self._emit("recovery_resume", dict(detail or {}, rung=rung,
                                           recovery_s=dt,
                                           booked_s=booked or dt))
        return dt

    def note_failed(self, reason, detail=None):
        with self._lock:
            t0 = self._incident_t0
            booked = self._incident_booked
            dt = (self._clock() - t0) if t0 is not None else 0.0
            self._state = "failed"
            self._failed = True
        residual = max(dt - booked, 0.0)
        if self.ledger is not None and residual > 0.0:
            try:
                self.ledger.note_comm_recovery(residual)
            except Exception:
                pass
        self._emit("recovery_failed", dict(detail or {}, reason=str(reason),
                                           recovery_s=dt))

    # -- ops-plane surface --------------------------------------------------------- #

    def status(self):
        """The ``/recovery`` endpoint body."""
        with self._lock:
            out = {
                "schema": SCHEMA_VERSION,
                "enabled": self.policy.enabled,
                "ladder_state": self._state,
                "incidents": self._incidents,
                "recoveries": self._recoveries,
                "last_abort": self._last_abort,
                "last_recovery_s": self._last_recovery_s,
                "world_size": self._world_size,
                "quarantined_ranks": list(self._quarantined),
                "policy": self.policy.to_json(),
            }
        if self.coordinator is not None:
            out["epoch"] = self.coordinator.epoch
            out["rank"] = self.coordinator.rank
        return out

    def health_check(self):
        """``/healthz`` contribution: unhealthy while an incident is in
        flight and latched unhealthy after a terminal failure; a
        *recovered* run reports healthy again (on a smaller world — the
        shrink is visible in ``world_size``/``quarantined_ranks``)."""
        with self._lock:
            active = self._state in ("aborting", "retry", "shrink",
                                     "restart")
            return {"ok": not (active or self._failed),
                    "ladder_state": self._state,
                    "incidents": self._incidents,
                    "world_size": self._world_size}


# --------------------------------------------------------------------------- #
# Agent-side recovery-exit markers (satellite S3)
# --------------------------------------------------------------------------- #

def write_recovery_marker(root, cause, epoch=0, extra=None):
    """Drop the coordinator-confirmed marker before a recovery exit so
    the supervising elastic agent classifies the (possibly ``-9``) exit
    like a preemption instead of a crash."""
    doc = dict(extra or {}, schema=SCHEMA_VERSION, cause=str(cause),
               epoch=int(epoch), pid=os.getpid(), t=time.time())
    os.makedirs(str(root), exist_ok=True)
    _write_json_atomic(os.path.join(str(root), _MARKER_NAME), doc)
    return doc


def consume_recovery_marker(root, max_age_s=600.0):
    """Agent side: read-and-consume the marker (one marker excuses one
    worker-group exit).  Returns the marker doc, or None when absent or
    stale."""
    if not root:
        return None
    path = os.path.join(str(root), _MARKER_NAME)
    doc = _read_json(path)
    if doc is None:
        return None
    try:
        os.replace(path, path + ".consumed")
    except OSError:
        return None
    if max_age_s is not None and time.time() - float(doc.get("t", 0)) \
            > max_age_s:
        return None
    return doc
