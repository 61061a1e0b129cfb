"""Engine checkpoint save and load, verified and atomic (counterpart of
``deepspeed_tpu/runtime/checkpointing.py``).

The JAX module's layout and behaviour, so the JAX package's offline
verifier (``tools/verify_checkpoint.py``) checks a port checkpoint as it
is::

    save_dir/
      latest                      <- text file with the newest tag
      zero_to_fp32.py             <- the port's recovery script
      <tag>/
        MANIFEST.json             <- per-file size + CRC-32, written post-commit
        state.pt | state.npz      <- params, optimizer state, scaler
        client_state.json         <- client_state + engine counters

* **Atomic saves**: the state is staged in a hidden ``.tmp.<tag>``
  sibling, checksummed into ``MANIFEST.json`` after the commit barrier,
  fsynced and renamed into place; only then does ``latest`` move (an
  fsync and ``os.replace``).
* **Retries**: transient ``OSError``\\ s back off exponentially before
  :class:`~deepspeed_tpu_torch.runtime.fault_tolerance.CheckpointWriteError`.
* **Rollback on load**: a torn, corrupt or missing newest tag walks back
  through at most ``max_rollback`` earlier verified tags.
* **Retention**: ``keep_last_n`` old tags are removed after each commit.
* **Async**: with ``checkpoint.async_save`` the save returns once the
  tensors are on the host; a finalizer thread commits, writes the
  manifest, promotes and moves ``latest``.  Its failure is raised at the
  next save, load or ``close``.
* **ZeRO**: the engine gathers its partitions into whole leaves, so the
  layout is stage 0's at every stage and world size; rank 0 writes it, and
  each rank's load takes its own partitions from it.  With the moments on
  NVMe the gather streams them from their chunk files piece by piece, and
  a load patches them piece by piece and writes every piece back to disk
  before the engine runs on (JAX's ``runtime/checkpointing.py:455-457``:
  the engine's ``_after_checkpoint_load`` resyncs its NVMe tiers), so
  nothing staged from the abandoned trajectory is read again.  A
  checkpoint has one layout whatever the tiers: one saved with NVMe loads
  into a CPU-offload or stage-0 engine, and the reverse.

Crash-critical boundaries carry the JAX module's ``fault_point`` sites
(``testing/fault_injection.py``): ``ckpt.pre_save`` before any state is
written, ``ckpt.mid_save`` after the state and before its metadata,
``ckpt.pre_commit`` before the commit barrier and ``ckpt.post_commit``
after ``latest`` moved.  With a telemetry hub on the engine it emits the
JAX module's events (``ckpt_retry`` per retried storage op, ``ckpt_saved``
once a tag is durable, ``ckpt_rollback`` when a load walked back), through
an ``_emit`` that never turns a checkpoint op into a crash; with a global
tracer the save's staging and the load's read are ``checkpoint.save`` /
``checkpoint.load`` spans.  The engine supplies ``_checkpoint_state()`` (the tree to
save), ``_checkpoint_copies(tree, ...)`` (every check of a loaded tree,
before anything is written) and ``_copy_in`` (the copies into its own
storage).
"""

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.checkpoint_engine import get_checkpoint_engine
from deepspeed_tpu_torch.runtime.checkpoint_engine.manifest import (atomic_write_json,
                                                                    atomic_write_text,
                                                                    fsync_dir, manifest_ok,
                                                                    write_manifest)
from deepspeed_tpu_torch.runtime.fault_tolerance import (CheckpointCorruptError,
                                                         CheckpointWriteError, retry_transient)
from deepspeed_tpu_torch.telemetry.tracing import maybe_span
from deepspeed_tpu_torch.testing.fault_injection import fault_point
from deepspeed_tpu_torch.utils.logging import log_dist, logger

LATEST_FILE = "latest"
STAGING_PREFIX = ".tmp."
STATE = "state"


def _ckpt_engine(engine):
    """The engine's storage backend, from the ``checkpoint`` block."""
    ce = getattr(engine, "checkpoint_engine", None)
    if ce is None:
        cc = engine._config.checkpoint_config
        ce = get_checkpoint_engine(cc.engine, async_save=cc.async_save)
        engine.checkpoint_engine = ce
    return ce


def _emit(engine, kind: str, payload: Dict[str, Any], flush: bool = False):
    """Telemetry emission that never turns a checkpoint op into a crash."""
    hub = getattr(engine, "telemetry", None)
    if hub is None:
        return
    try:
        hub.emit(kind, payload, step=getattr(engine, "global_steps", None))
        if flush:
            hub.flush()
    except Exception as e:
        logger.warning(f"checkpoint telemetry emission failed: {e}")


def _retry(engine, ft, what: str, fn):
    def on_retry(attempt, delay, exc):
        logger.warning(f"checkpoint {what} failed ({exc}); retry "
                       f"{attempt}/{ft.save_retries} in {delay:.2f}s")
        _emit(engine, "ckpt_retry", {"what": what, "attempt": attempt,
                                     "delay_s": delay, "error": str(exc)})
    try:
        return retry_transient(fn, retries=ft.save_retries, base_s=ft.retry_backoff_s,
                               max_s=ft.retry_backoff_max_s, on_retry=on_retry)
    except OSError as e:
        raise CheckpointWriteError(
            f"checkpoint {what} failed after {ft.save_retries} retries: {e}") from e


def wait_for_finalizer(engine, timeout: Optional[float] = None, raise_on_error: bool = True):
    """Join the async-save finalizer thread and surface its failure."""
    fin = getattr(engine, "_ckpt_finalizer", None)
    if fin is not None and fin.is_alive():
        fin.join(timeout)
        if fin.is_alive():
            logger.warning(f"checkpoint finalizer still running after {timeout}s join timeout")
    err = getattr(engine, "_ckpt_finalizer_error", None)
    if err is not None:
        engine._ckpt_finalizer_error = None
        if raise_on_error:
            raise CheckpointWriteError(f"previous async checkpoint finalize failed: {err}") from err
        logger.error(f"async checkpoint finalize failed: {err}")


# --------------------------------------------------------------------------- #
# Save
# --------------------------------------------------------------------------- #
def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None, save_latest: bool = True) -> bool:
    """Every rank calls it (a ZeRO engine gathers its partitions); rank 0
    writes, and the others wait for the commit (for an async save, for the
    state to be on the host)."""
    wait_for_finalizer(engine)
    tree = engine._checkpoint_state()
    engine._last_ckpt_dir = save_dir
    if comm.get_rank() != 0:
        comm.barrier()
        return True
    ft = engine._config.fault_tolerance_config
    tag = str(tag if tag is not None else f"global_step{engine.global_steps}")
    final_dir = os.path.join(save_dir, tag)
    os.makedirs(save_dir, exist_ok=True)

    atomic = bool(ft.atomic_save)
    work_dir = os.path.join(save_dir, STAGING_PREFIX + tag) if atomic else final_dir
    if atomic and os.path.isdir(work_dir):
        shutil.rmtree(work_dir)          # stale staging from a crashed save

    os.makedirs(work_dir, exist_ok=True)
    ce = _ckpt_engine(engine)
    with maybe_span("checkpoint.save", tag=tag, dir=save_dir):
        ce.create(tag)
        fault_point("ckpt.pre_save", tag=tag, path=work_dir)
        _retry(engine, ft, "save", lambda: ce.save(tree, os.path.join(work_dir, STATE)))
        del tree
        fault_point("ckpt.mid_save", tag=tag, path=work_dir)

    sched = engine.lr_scheduler
    meta = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "client_state": client_state or {},
        "lr_scheduler": sched.state_dict() if sched is not None and hasattr(
            sched, "state_dict") else None,
        "zero_stage": engine.zero_optimization_stage(),
        "world_size": comm.get_world_size(),
        "mesh_shape": {},
    }
    # the stability ladder's quarantine ring and counters ride in the
    # metadata, so a rollback or a restart keeps its quarantine (JAX layout)
    stability_state = engine._stability_state_for_checkpoint()
    if stability_state is not None:
        meta["stability"] = stability_state
    atomic_write_json(os.path.join(work_dir, "client_state.json"), meta)
    # the recovery script rides along with every checkpoint, as in the JAX
    # package (and the reference's engine)
    try:
        from deepspeed_tpu_torch.utils import zero_to_fp32 as _z2f
        shutil.copyfile(_z2f.__file__, os.path.join(save_dir, "zero_to_fp32.py"))
    except OSError as e:
        logger.warning(f"could not copy zero_to_fp32.py: {e}")
    global_steps = engine.global_steps

    def _finalize():
        # commit is the durability barrier; only a durable, verified
        # checkpoint may become 'latest'
        fault_point("ckpt.pre_commit", tag=tag, path=work_dir)
        _retry(engine, ft, "commit", lambda: ce.commit(tag))
        if atomic:
            write_manifest(work_dir, extra={"tag": tag, "global_steps": global_steps,
                                            "engine": type(ce).__name__})
            _promote(work_dir, final_dir)
        if save_latest:
            atomic_write_text(os.path.join(save_dir, LATEST_FILE), tag)
        fault_point("ckpt.post_commit", tag=tag, path=final_dir)
        _gc_old_tags(save_dir, keep_last_n=int(ft.keep_last_n), protect={tag})
        _emit(engine, "ckpt_saved", {"tag": tag, "dir": save_dir, "atomic": atomic})
        log_dist(f"saved checkpoint {final_dir}", ranks=[0])

    def _finalize_guarded():
        try:
            _finalize()
        except BaseException as e:       # surfaced at the next join point
            engine._ckpt_finalizer_error = e
            logger.error(f"async checkpoint finalize for tag {tag} failed: {e}")

    if getattr(ce, "async_save", False):
        t = threading.Thread(target=_finalize_guarded, daemon=True,
                             name=f"ckpt-finalize-{tag}")
        t.start()
        engine._ckpt_finalizer = t
    else:
        _finalize()
    comm.barrier()
    return True


def _promote(work_dir: str, final_dir: str):
    """Swap the staged checkpoint into its final name; an existing tag dir
    is parked under a hidden name first."""
    parent = os.path.dirname(final_dir)
    trash = None
    if os.path.isdir(final_dir):
        trash = os.path.join(parent, ".old." + os.path.basename(final_dir))
        if os.path.isdir(trash):
            shutil.rmtree(trash, ignore_errors=True)
        os.rename(final_dir, trash)
    os.rename(work_dir, final_dir)
    fsync_dir(parent)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def list_tags(save_dir: str) -> List[str]:
    """Visible tag dirs, newest first (natural sort: global_step10 beats
    global_step9)."""
    try:
        names = os.listdir(save_dir)
    except OSError:
        return []
    tags = []
    for name in names:
        d = os.path.join(save_dir, name)
        if name.startswith(".") or not os.path.isdir(d):
            continue
        if any(os.path.exists(os.path.join(d, f)) for f in (
                "client_state.json", "MANIFEST.json", STATE + ".pt", STATE + ".npz")):
            tags.append(name)
    return sorted(tags, key=_natural_key, reverse=True)


def _gc_old_tags(save_dir: str, keep_last_n: int, protect: set):
    """Drop tags beyond the newest ``keep_last_n`` (0 keeps all) and
    whatever ``latest`` does not name, and sweep stale hidden staging and
    park dirs."""
    latest_path = os.path.join(save_dir, LATEST_FILE)
    if os.path.isfile(latest_path):
        try:
            with open(latest_path) as f:
                protect = protect | {f.read().strip()}
        except OSError:
            pass
    try:
        for name in os.listdir(save_dir):
            if name.startswith(STAGING_PREFIX) or name.startswith(".old."):
                if (name[len(STAGING_PREFIX):] not in protect
                        and name[len(".old."):] not in protect):
                    shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
    except OSError:
        pass
    if keep_last_n <= 0:
        return
    for tag in list_tags(save_dir)[keep_last_n:]:
        if tag not in protect:
            shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
            log_dist(f"checkpoint retention: dropped old tag {tag}", ranks=[0])


# --------------------------------------------------------------------------- #
# Load (+ verification and rollback)
# --------------------------------------------------------------------------- #
def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True, load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False):
    """``(tag dir, client_state)``, or ``(None, {})`` when nothing was
    loaded."""
    wait_for_finalizer(engine)
    ft = engine._config.fault_tolerance_config
    explicit = tag is not None
    if not explicit:
        latest = os.path.join(load_dir, LATEST_FILE)
        if not os.path.isfile(latest):
            logger.warning(f"no 'latest' file at {latest}; nothing loaded")
            return None, {}
        try:
            with open(latest) as f:
                tag = f.read().strip()
        except OSError as e:
            logger.warning(f"unreadable 'latest' file at {latest} ({e}); scanning for tags")
            tag = ""

    rollback_ok = (not explicit) and bool(ft.rollback)
    candidates = _candidate_tags(load_dir, tag, ft) if rollback_ok else [str(tag)]
    failures: List[Dict[str, Any]] = []
    for cand in candidates:
        ok, report = _verify_tag(engine, load_dir, cand, ft)
        if not ok:
            status = report.get("status", "corrupt")
            if status == "missing" and not failures and not rollback_ok:
                logger.warning(f"checkpoint {os.path.join(load_dir, str(cand))} not found")
                return None, {}
            failures.append({"tag": cand, "status": status, "errors": report.get("errors", [])})
            logger.error(f"checkpoint tag {cand!r} failed verification ({status}): "
                         f"{report.get('errors', [])[:3]}")
            if not rollback_ok:
                raise CheckpointCorruptError(
                    f"checkpoint {os.path.join(load_dir, str(cand))} is {status} and rollback "
                    f"is disabled (explicit tag or fault_tolerance.rollback=false): "
                    f"{report.get('errors')}")
            continue
        try:
            result = _load_tag(engine, load_dir, cand, load_optimizer_states,
                               load_lr_scheduler_states, load_module_only)
        except Exception as e:
            if not rollback_ok:
                raise
            failures.append({"tag": cand, "status": "load_error", "errors": [str(e)]})
            logger.error(f"restore of tag {cand!r} failed ({e}); rolling back")
            continue
        if failures:
            _emit(engine, "ckpt_rollback",
                  {"dir": load_dir, "from_tag": candidates[0], "to_tag": cand,
                   "failures": failures}, flush=True)
            logger.warning(f"rolled back from {candidates[0]!r} to last verified "
                           f"checkpoint {cand!r}")
        return result
    if failures:
        _emit(engine, "ckpt_rollback",
              {"dir": load_dir, "from_tag": candidates[0] if candidates else None,
               "to_tag": None, "failures": failures}, flush=True)
    logger.warning(f"no verified checkpoint under {load_dir}; nothing loaded")
    return None, {}


def _candidate_tags(load_dir: str, requested: str, ft) -> List[str]:
    """The requested tag first, then earlier tags newest first, at most
    1 + ``max_rollback``."""
    out = [requested] if requested else []
    out += [t for t in list_tags(load_dir) if t not in out]
    return out[:1 + max(0, int(ft.max_rollback))]


def _verify_tag(engine, load_dir: str, tag: str, ft):
    if not tag:
        return False, {"status": "missing"}
    ckpt_dir = os.path.join(load_dir, str(tag))
    if not os.path.isdir(ckpt_dir) or not _ckpt_engine(engine).exists(
            os.path.join(ckpt_dir, STATE)):
        return False, {"status": "missing", "dir": ckpt_dir}
    if not ft.verify_on_load:
        return True, {"status": "unverified", "dir": ckpt_dir}
    return manifest_ok(ckpt_dir)


def _load_tag(engine, load_dir: str, tag: str, load_optimizer_states: bool,
              load_lr_scheduler_states: bool, load_module_only: bool):
    ckpt_dir = os.path.join(load_dir, str(tag))
    with maybe_span("checkpoint.load", tag=str(tag), dir=load_dir):
        tree = _ckpt_engine(engine).load(os.path.join(ckpt_dir, STATE))
    meta_path = os.path.join(ckpt_dir, "client_state.json")
    meta = None
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    # every check before the first write: a tag that does not fit this
    # engine raises and leaves it as it was, for rollback to go on from
    copies = engine._checkpoint_copies(
        tree, load_optimizer_states=load_optimizer_states and not load_module_only)
    sched = engine.lr_scheduler
    if (load_lr_scheduler_states and sched is not None
            and meta is not None and meta.get("lr_scheduler") is not None
            and hasattr(sched, "load_state_dict")):
        sched.load_state_dict(meta["lr_scheduler"])
    engine._copy_in(copies)
    client_state = {}
    if meta is not None:
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        engine.micro_steps = meta.get("micro_steps", 0)
        client_state = meta.get("client_state", {})
    # the stability ladder's state and LR scale; the sentinel starts afresh
    engine._after_checkpoint_load(meta)
    log_dist(f"loaded checkpoint {ckpt_dir} at step {engine.global_steps}", ranks=[0])
    return ckpt_dir, client_state


def load_params_only(load_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """The fp32 master parameters of a training checkpoint, by name, as CPU
    tensors (the inference engine's load; counterpart of the JAX module's
    ``load_params_only``): tag ``tag``, or the one ``latest`` names, held
    against its manifest first; either store (``state.pt`` or
    ``state.npz``)."""
    if tag is None:
        with open(os.path.join(load_dir, LATEST_FILE)) as f:
            tag = f.read().strip()
    ckpt_dir = os.path.join(load_dir, str(tag))
    ok, report = manifest_ok(ckpt_dir)
    if not ok:
        raise CheckpointCorruptError(f"checkpoint {ckpt_dir} is corrupt: {report.get('errors')}")
    path = os.path.join(ckpt_dir, STATE)
    for name in ("torch", "local"):
        store = get_checkpoint_engine(name)
        if store.exists(path):
            params = store.load(path)["params"]
            log_dist(f"loaded params from {ckpt_dir}", ranks=[0])
            return params
    raise FileNotFoundError(f"checkpoint {ckpt_dir} holds no state file")
