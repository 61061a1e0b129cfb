"""Deterministic fault injection harness (the port's own copy of
``deepspeed_tpu/testing/fault_injection.py``: the same sites, actions,
plans and ``DS_FAULT_PLAN`` variable, so one plan drives both packages).

The fault-tolerance layer (atomic checkpoints, rollback, preemption,
elastic restarts) is only trustworthy if every recovery path can be
exercised on demand.  This module provides scripted, *deterministic*
failures at named ``fault_point`` sites that the runtime calls at its
crash-critical boundaries:

====================  =====================================================
site                  fires
====================  =====================================================
``ckpt.pre_save``     before the checkpoint engine writes any state
``ckpt.mid_save``     after state bytes, before metadata/manifest
``ckpt.pre_commit``   inside finalize, before the durability barrier
``ckpt.post_commit``  after commit + atomic rename + ``latest`` move
``train.step``        once per optimizer step (ctx: ``step``)
``comm.collective``   per staged collective (ctx: ``op``)
``serve.step``        inside the bounded serve-step dispatch (ctx: ``step``,
                      ``phase``) — wedge/delay/raise drive serving incidents
``serve.restage``     before a tiered KV restage (ctx: ``rid``) — raise
                      forces the recompute fallback
``engine.*``          :class:`FaultyCheckpointEngine` wrapper sites
====================  =====================================================

Two **value sites**, ``train.loss`` (the loss the stability sentinel
judges at the step boundary) and ``train.grads`` (the accumulated
gradients), take numeric actions (``nan``/``inf``/``spike``) that corrupt
the value instead of crashing the process, on the same hits as JAX's.
A hit's numeric rules compose into one affine pair ``(mult, add)``,
``value * mult + add`` their effect on every finite value (``1`` and
``-0.0`` on a clean hit, which leave every value bit for bit).  A replay of
the engine's captured step runs no host code, so the engine plants the two
sites as a device seam (:func:`numeric_seam`): the host writes the pair
into static device scalars before each step, eager or replayed, and the
update applies it.  The seam is in the step only when a plan with a rule
at a value site is installed (:func:`value_sites_armed`); a clean graph
keeps its nodes.  :func:`numeric_fault` (JAX's hook) applies the same pair
to the floating leaves of a host value.

A *plan* is a JSON list of rules.  Each rule names a site, an action, and
the 1-based hit count it fires on — so "kill the process the 3rd time a
save reaches pre-commit" is ``{"site": "ckpt.pre_commit", "action":
"kill", "on_hit": 3}``.  Plans come from :func:`install_plan` (in
process) or the ``DS_FAULT_PLAN`` env var (subprocess crash tests: a JSON
string, or ``@/path/to/plan.json``).  Plans are schema-validated at
install: an unknown action OR an unknown site raises ``ValueError``
immediately — a typoed rule must fail loudly, never silently no-op.

Two actions model the collective failure classes the recovery ladder
(``comm/recovery.py``) is built against: ``kill`` with a ``"signal"``
parameter dies by signal (``{"signal": 9}`` → the parent observes
rc=-9, a rank SIGKILLed mid-collective), and ``wedge`` parks the firing
thread in an infinite-but-interruptible stall (released by
:func:`release_wedges`, which a bounded-collective timeout triggers, or
by an optional ``max_wedge_s`` cap).

With no plan installed, ``fault_point`` is a nearly-free no-op — the
production hot path pays one global read and a ``None`` check.

Only the standard library is imported at module level, apart from the
checkpoint engine the wrapper at the bottom subclasses; a numeric rule
imports torch when it fires.
"""

import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

PLAN_ENV = "DS_FAULT_PLAN"

# numeric actions corrupt a value at a value site instead of crashing;
# "spike" multiplies by the rule's "factor" (default 1e3)
NUMERIC_ACTIONS = ("nan", "inf", "spike")
ACTIONS = ("kill", "raise", "sigterm", "delay", "wedge", "bitflip",
           "truncate") + NUMERIC_ACTIONS

#: every fault_point / numeric_fault / FaultyCheckpointEngine site the
#: runtime plants — plan validation rejects anything else (a typoed site
#: must fail loudly, not silently never fire)
SITES = (
    "ckpt.pre_save", "ckpt.mid_save", "ckpt.pre_commit", "ckpt.post_commit",
    "train.step",
    "comm.collective",
    "engine.create", "engine.save", "engine.post_save", "engine.commit",
    "engine.load",
    # serving resilience plane: `serve.step` fires inside the bounded
    # compiled-step dispatch (ctx: step, phase=prefill|decode) — wedge it
    # to drive a ServeStepTimeout incident; `serve.restage` fires before a
    # tiered KV restore (ctx: rid) — raise to force the recompute fallback
    "serve.step", "serve.restage",
    # value sites (numeric_fault / numeric_seam): the sentinel's loss and
    # the accumulated gradients at the step boundary (ctx: step, fp)
    "train.loss", "train.grads",
)

#: the value sites among SITES
VALUE_SITES = ("train.loss", "train.grads")
#: the ``(mult, add)`` of a value-site hit at which no numeric rule fires
CLEAN_SEAM = (1.0, -0.0)

# `wedge` parks the firing thread until released — the infinite-delay
# model of a stuck peer, interruptible so a bounded-collective timeout
# (or test teardown) can let the abandoned thread drain
_WEDGE_RELEASE = threading.Event()


def release_wedges():
    """Release every thread currently parked in a ``wedge`` action (and
    any future hits of already-armed wedge rules)."""
    _WEDGE_RELEASE.set()


def arm_wedges():
    """Re-arm ``wedge`` actions after a :func:`release_wedges`."""
    _WEDGE_RELEASE.clear()


class FaultInjected(OSError):
    """The error the ``raise`` action throws.  An ``OSError`` subclass on
    purpose: injected storage faults must travel the same
    retry-on-transient-error path real ``OSError``\\ s do."""


class FaultRule:
    """One scripted fault.  Dict form::

        {"site": "ckpt.pre_commit",       # fault_point site name
         "action": "kill",                # one of ACTIONS
         "on_hit": 3,                     # fire on the Nth matching hit
         "times": 1,                      # ... and the times-1 hits after it
         "match": {"tag": "global_step3"},# optional ctx equality filter
         # action parameters:
         "exit_code": 9,                  # kill (os._exit code)
         "signal": 9,                     # kill by signal instead (rc=-9)
         "message": "...", "errno": 5,    # raise
         "delay_s": 0.05,                 # delay
         "max_wedge_s": 30.0,             # wedge hard cap (default: none)
         "path": "...", "offset": 12}     # bitflip / truncate
    """

    def __init__(self, spec: Dict[str, Any]):
        self.spec = dict(spec)
        if "site" not in spec:
            raise ValueError(f"fault rule missing 'site': {spec!r}")
        self.site = str(spec["site"])
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        self.action = str(spec.get("action", "raise"))
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {ACTIONS})")
        self.on_hit = int(spec.get("on_hit", 1))
        self.times = int(spec.get("times", 1))
        self.match = dict(spec.get("match", {}))
        self.hits = 0

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if site != self.site:
            return False
        for k, v in self.match.items():
            if k not in ctx or str(ctx[k]) != str(v):
                return False
        return True

    def should_fire(self) -> bool:
        return self.on_hit <= self.hits < self.on_hit + self.times


class FaultInjector:
    """Holds the rule list and per-rule hit counters.  Counters make the
    plan deterministic: the same run hits the same sites in the same
    order, so "the Nth hit" is a reproducible point in time."""

    def __init__(self, rules: List[Dict[str, Any]]):
        self.rules = [r if isinstance(r, FaultRule) else FaultRule(r)
                      for r in (rules or [])]
        self.log: List[Dict[str, Any]] = []   # fired (site, action, ctx)

    @property
    def active(self) -> bool:
        return bool(self.rules)

    def fire(self, site: str, **ctx):
        for rule in self.rules:
            if not rule.matches(site, ctx):
                continue
            rule.hits += 1
            if rule.should_fire():
                self.log.append({"site": site, "action": rule.action,
                                 "hit": rule.hits, "ctx": dict(ctx)})
                self._execute(rule, site, ctx)

    def transform(self, site: str, value, **ctx):
        """Value-site counterpart of :func:`fire`: ``value`` with this
        hit's :meth:`seam` applied to its floating leaves (``value`` itself
        when no numeric rule fires)."""
        mult, add = self.seam(site, **ctx)
        if (mult, add) == CLEAN_SEAM:
            return value
        return _corrupt_value(value, mult, add)

    def seam(self, site: str, **ctx):
        """One hit of a value site: the matching rules' 1-based hit
        counters advance as at :meth:`fire`, and the numeric rules that
        fire are composed into ``(mult, add)`` with ``value * mult + add``
        their effect on every finite value (``nan``: NaN, ``inf``: +inf,
        ``spike``: times its ``factor``); :data:`CLEAN_SEAM` when none
        fires.  Non-numeric rules at a value site still execute (a
        ``kill`` at ``train.loss`` is legal)."""
        mult, add = CLEAN_SEAM
        for rule in self.rules:
            if not rule.matches(site, ctx):
                continue
            rule.hits += 1
            if rule.should_fire():
                self.log.append({"site": site, "action": rule.action,
                                 "hit": rule.hits, "ctx": dict(ctx)})
                if rule.action == "nan":
                    mult, add = float("nan"), float("nan")
                elif rule.action == "inf":
                    mult, add = 1.0, float("inf")
                elif rule.action == "spike":
                    factor = float(rule.spec.get("factor", 1e3))
                    mult, add = mult * factor, add * factor
                else:
                    self._execute(rule, site, ctx)
        return mult, add

    # ------------------------------------------------------------------ #
    def _execute(self, rule: FaultRule, site: str, ctx: Dict[str, Any]):
        spec = rule.spec
        if rule.action == "kill":
            if spec.get("signal") is not None:
                # die by signal: the parent's Popen sees rc = -N, the
                # exact shape of a SIGKILLed-mid-collective rank
                os.kill(os.getpid(), int(spec["signal"]))
                time.sleep(30.0)   # SIGKILL needs no handler; never runs on
                return             # -9 — reached only for catchable signals
            # os._exit: no atexit, no finally blocks — a real crash, which
            # is exactly what the atomic-save guarantees are tested against
            os._exit(int(spec.get("exit_code", 9)))
        if rule.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if rule.action == "raise":
            raise FaultInjected(
                int(spec.get("errno", 5)),
                str(spec.get("message", f"injected fault at {site}")))
        if rule.action == "delay":
            time.sleep(float(spec.get("delay_s", 0.01)))
            return
        if rule.action == "wedge":
            # infinite-but-interruptible stall: the stuck-peer model.  The
            # parked thread drains the moment release_wedges() runs (a
            # bounded-collective timeout fires it) or the cap expires.
            cap = spec.get("max_wedge_s")
            deadline = (time.monotonic() + float(cap)) if cap else None
            while not _WEDGE_RELEASE.wait(0.05):
                if deadline is not None and time.monotonic() >= deadline:
                    break
            return
        if rule.action in NUMERIC_ACTIONS:
            # numeric actions only make sense at a value site (numeric_fault)
            return
        path = _resolve_path(spec.get("path") or ctx.get("path"))
        if rule.action == "bitflip":
            bitflip_file(path, offset=spec.get("offset"))
            return
        if rule.action == "truncate":
            truncate_file(path, size=int(spec.get("size", 0)))


def _corrupt_value(value, mult: float, add: float):
    """``x * mult + add`` for every floating tensor ``x`` of a (possibly
    nested dict, list or tuple) value; other leaves pass through
    unchanged."""
    import torch

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v) for v in x)
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            return x
        return t * mult + add

    return leaf(value)


def _resolve_path(path: Optional[str]) -> str:
    """A concrete regular file to corrupt.  Directories resolve to their
    first non-empty file in sorted-walk order — deterministic, so a rule
    aimed at a checkpoint dir always hits the same file; a path that is
    not there resolves to the first file named ``<path>.<suffix>``."""
    if not path:
        raise ValueError("bitflip/truncate need a 'path' (rule or ctx)")
    if not os.path.exists(path):
        # the port's engines save ``<path>`` as ``<path>.pt`` / ``.npz``
        parent, base = os.path.split(path)
        for name in sorted(os.listdir(parent or ".")):
            if name.startswith(base + "."):
                return os.path.join(parent, name)
    if os.path.isdir(path):
        for root, dirs, names in sorted(os.walk(path)):
            dirs.sort()
            for name in sorted(names):
                p = os.path.join(root, name)
                if os.path.isfile(p) and os.path.getsize(p) > 0:
                    return p
        raise FileNotFoundError(f"no non-empty file under {path}")
    return path


def bitflip_file(path: str, offset: Optional[int] = None):
    """XOR one byte (default: the middle one) — the minimal storage-rot
    model a checksum must catch."""
    path = _resolve_path(path)
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bitflip empty file {path}")
    off = size // 2 if offset is None else int(offset) % size
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0xFF]))


def truncate_file(path: str, size: int = 0):
    """Torn-write model: the file exists but lost its tail."""
    path = _resolve_path(path)
    with open(path, "r+b") as f:
        f.truncate(size)


# --------------------------------------------------------------------------- #
# Global plan: fault_point() is what the runtime calls
# --------------------------------------------------------------------------- #
_injector: Optional[FaultInjector] = None
_env_checked = False


def install_plan(plan) -> FaultInjector:
    """Install a plan in-process (tests).  ``plan`` is a rule list, a JSON
    string, or an existing :class:`FaultInjector`."""
    global _injector, _env_checked
    if isinstance(plan, str):
        plan = json.loads(plan)
    _injector = plan if isinstance(plan, FaultInjector) else FaultInjector(plan)
    _env_checked = True
    return _injector


def clear_plan():
    global _injector, _env_checked
    _injector = None
    _env_checked = False
    # a released wedge must not leak into the next test's plan
    arm_wedges()


def get_injector() -> Optional[FaultInjector]:
    """The installed injector, lazily loading ``DS_FAULT_PLAN`` from the
    environment exactly once (subprocess crash tests set it)."""
    global _injector, _env_checked
    if _injector is None and not _env_checked:
        _env_checked = True
        raw = os.environ.get(PLAN_ENV, "")
        if raw:
            if raw.startswith("@"):
                with open(raw[1:]) as f:
                    raw = f.read()
            _injector = FaultInjector(json.loads(raw))
    return _injector


def fault_point(site: str, **ctx):
    """Hook the runtime plants at a crash-critical boundary.  No-op (one
    global read) unless a plan with a rule for ``site`` is installed."""
    inj = _injector if _env_checked else get_injector()
    if inj is not None and inj.active:
        inj.fire(site, **ctx)


def numeric_fault(site: str, value, **ctx):
    """Value-site hook: returns ``value`` unchanged (one global read, no
    copies) unless a plan is installed, in which case matching numeric
    rules corrupt it (``nan``/``inf``/``spike``) on their scripted hits."""
    inj = _injector if _env_checked else get_injector()
    if inj is None or not inj.active:
        return value
    return inj.transform(site, value, **ctx)


def value_sites_armed() -> bool:
    """Whether the installed plan has a rule at a value site: the engine
    then captures its step with the device seam."""
    inj = _injector if _env_checked else get_injector()
    return inj is not None and any(r.site in VALUE_SITES for r in inj.rules)


def numeric_seam(site: str, **ctx):
    """Value-site hook for a device seam: ``(mult, add)`` for this hit of
    ``site`` (``(1.0, -0.0)`` without a plan), see
    :meth:`FaultInjector.seam`."""
    inj = _injector if _env_checked else get_injector()
    if inj is None or not inj.active:
        return CLEAN_SEAM
    return inj.seam(site, **ctx)


# --------------------------------------------------------------------------- #
# FaultyCheckpointEngine — storage-level injection wrapper
# --------------------------------------------------------------------------- #
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (  # noqa: E402
    CheckpointEngine)


class FaultyCheckpointEngine(CheckpointEngine):
    """Wraps a real checkpoint engine and runs fault sites around every
    storage call, so "raise OSError on the Nth write", "corrupt the bytes
    a save just produced", or "die inside commit" are one plan rule away.

    Sites (ctx carries ``path``/``tag`` so bitflip rules can omit it):

    * ``engine.create``     — before inner ``create``
    * ``engine.save``       — before inner ``save``  (``raise`` → Nth-write OSError)
    * ``engine.post_save``  — after inner ``save``   (``bitflip`` → silent rot)
    * ``engine.commit``     — before inner ``commit``
    * ``engine.load``       — before inner ``load``

    The port's engines write ``<path>.pt`` / ``<path>.npz``, so a bitflip
    rule at ``engine.post_save`` names its file with ``path`` (the
    directory of the staged tag also works: its first non-empty file).
    """

    def __init__(self, inner: CheckpointEngine,
                 injector: Optional[FaultInjector] = None):
        self.inner = inner
        self.injector = injector

    @property
    def async_save(self):
        return getattr(self.inner, "async_save", False)

    def _fire(self, site: str, **ctx):
        if self.injector is not None:
            self.injector.fire(site, **ctx)
        else:
            fault_point(site, **ctx)

    def create(self, tag: str):
        self._fire("engine.create", tag=tag)
        return self.inner.create(tag)

    def save(self, state, path: str):
        self._fire("engine.save", path=path)
        out = self.inner.save(state, path)
        self._fire("engine.post_save", path=path)
        return out

    def load(self, path: str):
        self._fire("engine.load", path=path)
        return self.inner.load(path)

    def commit(self, tag: str) -> bool:
        self._fire("engine.commit", tag=tag)
        return self.inner.commit(tag)

    def exists(self, path: str) -> bool:
        return self.inner.exists(path)

    def wait(self):
        return self.inner.wait()
