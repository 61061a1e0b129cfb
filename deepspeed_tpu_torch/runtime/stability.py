"""Training-stability sentinel: anomaly detection inside the step and the
recovery ladder (counterpart of ``deepspeed_tpu/runtime/stability.py``).

Two halves, split as in the JAX package:

* **Device half** — :class:`SentinelState` (0-dim device tensors) and the
  pure function :func:`sentinel_observe`, written as torch ops with no host
  read, so the engine runs them inside its captured CUDA graph.  The
  detectors (non-finite loss or gradients, a grad-norm spike against an
  EMA window, a loss spike by z-score, loss-scale collapse) give one int32
  cause code; the engine turns it into the fused AdamW kernel's skip flag,
  so an anomalous update is suppressed on the device (a graph has no host
  branch, where JAX uses ``lax.cond``).

* **Host half** — :class:`StabilitySentinel`, the policy ladder.  The engine
  hands it the stats of each optimizer boundary; it buffers them and judges
  the *previous* boundary's cause code, which the previous replay has
  already written (the lagged read of the JAX package: the clean path never
  waits on the step in flight).  An anomaly therefore surfaces on the host
  at most one step after it happened.  The ladder escalates: skip (already
  done on the device) -> LR backoff after K consecutive anomalies ->
  rollback to the last verified checkpoint after M, quarantining the
  fingerprints of the offending batches so that the replayed run skips
  them.

Batch fingerprints (:func:`fingerprint_batch`) hash numpy's dtype name, the
shape and the C-contiguous bytes of every host leaf, so a fingerprint is
the same in both packages and a quarantine set saved by one is honoured by
the other.  Device-resident batches are not fingerprinted.  The quarantine
set and the ladder's counters go into the checkpoint (``state_dict`` /
``load_state_dict``) with the JAX package's merge rules: quarantine entries
union, ``auto_rollbacks`` never moves backwards.
"""

import hashlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

# ---------------------------------------------------------------------------
# cause codes (int32, 0 = clean).  Order is detection priority: when several
# detectors fire on one step the lowest code wins.
# ---------------------------------------------------------------------------
OK = 0
NONFINITE_LOSS = 1
NONFINITE_GRADS = 2
GRAD_SPIKE = 3
LOSS_SPIKE = 4
SCALE_COLLAPSE = 5

CAUSE_NAMES = {
    OK: "ok",
    NONFINITE_LOSS: "nonfinite_loss",
    NONFINITE_GRADS: "nonfinite_grads",
    GRAD_SPIKE: "grad_norm_spike",
    LOSS_SPIKE: "loss_spike",
    SCALE_COLLAPSE: "scale_collapse",
}

# ladder actions (host side)
ACTION_SKIP = "skip"
ACTION_LR_BACKOFF = "lr_backoff"
ACTION_ROLLBACK = "rollback"


class SentinelState(NamedTuple):
    """Device-resident detector state, all 0-dim tensors (fp32 statistics,
    int32 counters)."""
    loss_ema: torch.Tensor        # EW mean of the loss over clean steps
    loss_var: torch.Tensor        # EW variance of the loss (West's update)
    gnorm_ema: torch.Tensor       # EW mean of the global grad norm
    good_steps: torch.Tensor      # clean steps seen (arms the detectors)
    consecutive: torch.Tensor     # current anomaly streak
    anomaly_count: torch.Tensor   # anomalies since init
    last_code: torch.Tensor       # cause code of the latest observation
    scale_low_streak: torch.Tensor  # boundaries with the dynamic scale at min


def init_sentinel_state(device=None) -> SentinelState:
    """Fresh (unarmed) sentinel state; the EMAs seed from the first clean
    step."""
    f = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    i = lambda: torch.zeros((), dtype=torch.int32, device=device)    # noqa: E731
    return SentinelState(loss_ema=f(), loss_var=f(), gnorm_ema=f(), good_steps=i(),
                         consecutive=i(), anomaly_count=i(), last_code=i(),
                         scale_low_streak=i())


@torch.no_grad()
def reset_sentinel_state_(state: SentinelState) -> None:
    """Zero ``state`` in place (a captured step keeps its pointers)."""
    for t in state:
        t.zero_()


@torch.no_grad()
def assign_sentinel_state_(dst: SentinelState, src: SentinelState) -> None:
    """Copy ``src`` into ``dst`` in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _f32(v: float) -> float:
    """``v`` rounded to fp32: the value a weakly typed Python float takes in
    an fp32 JAX expression."""
    return float(np.float32(v))


def sentinel_observe(state: SentinelState, loss: torch.Tensor, grad_norm: torch.Tensor,
                     overflow: torch.Tensor, at_min_scale: torch.Tensor, *,
                     warmup_steps: int, ema_alpha: float, grad_spike_factor: float,
                     loss_spike_zscore: float,
                     scale_collapse_windows: int) -> Tuple[SentinelState, torch.Tensor]:
    """One detector pass -> (new state, int32 cause code), as torch ops on
    0-dim tensors with no host read (capturable).

    The keyword thresholds are constants (the ``stability`` block).  The
    EMA statistics move only on clean steps (an anomalous loss must not
    poison the baseline it is judged against), and the spike detectors stay
    disarmed until ``warmup_steps`` clean observations have seeded the
    window.  Every operation rounds to fp32 as the JAX function's does.
    """
    loss = loss.to(torch.float32).reshape(())
    grad_norm = grad_norm.to(torch.float32).reshape(())
    overflow = overflow.to(torch.bool).reshape(())
    at_min_scale = at_min_scale.to(torch.bool).reshape(())
    a = _f32(ema_alpha)
    one_minus_a = float(np.float32(1.0) - np.float32(ema_alpha))

    nf_loss = ~torch.isfinite(loss)
    nf_grads = overflow | ~torch.isfinite(grad_norm)
    armed = state.good_steps >= int(warmup_steps)
    l_dev = loss - state.loss_ema
    g_spike = armed & (grad_norm > _f32(grad_spike_factor)
                       * torch.clamp(state.gnorm_ema, min=_f32(1e-12)))
    l_sigma = torch.sqrt(torch.clamp(state.loss_var, min=0.0)) + _f32(1e-8)
    # one-sided: a loss *drop* is never an anomaly
    l_spike = armed & (l_dev > _f32(loss_spike_zscore) * l_sigma)
    low_streak = torch.where(at_min_scale, state.scale_low_streak + 1,
                             torch.zeros_like(state.scale_low_streak))
    collapse = low_streak >= int(scale_collapse_windows)

    code = torch.where(nf_loss, NONFINITE_LOSS,
           torch.where(nf_grads, NONFINITE_GRADS,                      # noqa: E128
           torch.where(g_spike, GRAD_SPIKE,                            # noqa: E128
           torch.where(l_spike, LOSS_SPIKE,                            # noqa: E128
           torch.where(collapse, SCALE_COLLAPSE, OK))))).to(torch.int32)  # noqa: E128
    anomaly = code > 0
    clean = ~anomaly
    first = state.good_steps == 0
    zero = torch.zeros_like(loss)

    # EW mean / variance (West): only clean steps move the window; the very
    # first clean step seeds the mean
    new_loss_ema = torch.where(clean, torch.where(first, loss, state.loss_ema + a * l_dev),
                               state.loss_ema)
    new_loss_var = torch.where(
        clean, torch.where(first, zero, one_minus_a * (state.loss_var + a * l_dev * l_dev)),
        state.loss_var)
    new_gnorm_ema = torch.where(
        clean, torch.where(first, grad_norm,
                           state.gnorm_ema + a * (grad_norm - state.gnorm_ema)),
        state.gnorm_ema)
    new_state = SentinelState(
        loss_ema=new_loss_ema,
        loss_var=new_loss_var,
        gnorm_ema=new_gnorm_ema,
        good_steps=state.good_steps + clean.to(torch.int32),
        consecutive=torch.where(anomaly, state.consecutive + 1,
                                torch.zeros_like(state.consecutive)).to(torch.int32),
        anomaly_count=state.anomaly_count + anomaly.to(torch.int32),
        last_code=code,
        scale_low_streak=low_streak.to(torch.int32))
    return new_state, code


# ---------------------------------------------------------------------------
# batch fingerprinting
# ---------------------------------------------------------------------------
def _batch_leaves(batch: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(batch, dict):
        return [x for k in sorted(batch) for x in _batch_leaves(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [x for v in batch for x in _batch_leaves(v)]
    if batch is None:
        return []
    return [batch]


def fingerprint_batch(batch: Any) -> Optional[str]:
    """Content hash (blake2b, 64-bit hex) of a batch tree, or ``None``.

    Hashes numpy's dtype name, the shape and the C-contiguous bytes of
    every leaf, as the JAX function does, so both packages give one
    fingerprint for one batch (a torch ``int32`` tensor hashes as numpy's
    ``int32``).  Returns ``None`` when a leaf lives on a device: reading it
    back would be the very sync the sentinel avoids, so such batches are not
    quarantine-eligible.
    """
    leaves = _batch_leaves(batch)
    if not leaves:
        return None
    h = hashlib.blake2b(digest_size=8)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type != "cpu":
                return None
            t = leaf.detach().contiguous()
            if t.dtype == torch.bfloat16:
                arr = t.view(torch.int16).numpy()
                name = "bfloat16"
            else:
                arr = t.numpy()
                name = str(arr.dtype)
        else:
            arr = np.asarray(leaf)
            name = str(arr.dtype)
        h.update(name.encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class StabilitySentinel:
    """Host-side policy ladder over the device sentinel's cause codes (the
    JAX package's class, line for line).

    ``observe(step, stats, fingerprints)`` buffers the current boundary's
    stats and *judges the previous one* (a lagged read: no wait on the step
    in flight).  It returns ``None`` on a clean previous step, or an action
    dict ``{"action": skip|lr_backoff|rollback, "step", "code", "cause",
    "consecutive"}`` for the engine to execute.  The sentinel emits
    ``anomaly`` telemetry itself; the engine emits ``lr_backoff``,
    ``auto_rollback`` and ``batch_quarantined`` once it has performed them.
    ``read_fn`` is the one host read of a stat (a float, a numpy value or a
    host tensor).
    """

    def __init__(self, config, telemetry=None, read_fn=None):
        self.config = config
        self.telemetry = telemetry
        self.read_fn = read_fn if read_fn is not None else (lambda v: float(np.asarray(v)))
        self._pending = None            # last boundary, not yet judged
        self.consecutive = 0            # host view of the anomaly streak
        self.lr_backoffs = 0
        self.auto_rollbacks = 0
        self.anomalies_total = 0
        # fingerprints of the batches of the current anomaly episode: the
        # quarantine candidates if the episode escalates to rollback
        self._episode_fps: List[str] = []
        # recent per-step fingerprints, newest last
        self.ring = deque(maxlen=max(int(config.quarantine_ring), 1))
        # fp -> global step at which it was quarantined (insertion-ordered)
        self._quarantined: "OrderedDict[str, int]" = OrderedDict()

    # -- quarantine ------------------------------------------------------- #
    fingerprint = staticmethod(fingerprint_batch)

    def is_quarantined(self, fp: Optional[str]) -> bool:
        return bool(fp) and fp in self._quarantined

    def quarantine(self, fps: Sequence[str], step: int) -> List[str]:
        """Add fingerprints to the quarantine set -> the newly added ones."""
        if not self.config.quarantine:
            return []
        added = []
        for fp in fps:
            if fp and fp not in self._quarantined:
                self._quarantined[fp] = int(step)
                added.append(fp)
        while len(self._quarantined) > self.ring.maxlen:
            self._quarantined.popitem(last=False)
        return added

    def quarantined(self) -> Dict[str, int]:
        return dict(self._quarantined)

    def episode_fingerprints(self) -> List[str]:
        """Quarantine candidates of the current anomaly episode (deduped)."""
        out, seen = [], set()
        for fp in self._episode_fps:
            if fp not in seen:
                seen.add(fp)
                out.append(fp)
        return out

    # -- the ladder ------------------------------------------------------- #
    def observe(self, step: int, stats: Dict[str, Any],
                fingerprints: Sequence[str] = ()) -> Optional[Dict[str, Any]]:
        fps = [fp for fp in fingerprints if fp]
        if fps:
            self.ring.append({"step": int(step), "fps": fps})
        prev, self._pending = self._pending, {
            "step": int(step),
            "code": stats.get("anomaly_code"),
            "loss": stats.get("loss"),
            "grad_norm": stats.get("grad_norm"),
            "loss_scale": stats.get("loss_scale"),
            "fps": fps,
        }
        if prev is None:
            return None
        return self._judge(prev, detected_at=int(step))

    def drain(self) -> Optional[Dict[str, Any]]:
        """Judge the buffered boundary now (end of run, tests)."""
        prev, self._pending = self._pending, None
        if prev is None:
            return None
        return self._judge(prev, detected_at=prev["step"])

    def _judge(self, rec, detected_at: int) -> Optional[Dict[str, Any]]:
        code = 0 if rec["code"] is None else int(self.read_fn(rec["code"]))
        if code <= 0:
            if self.consecutive:
                self.consecutive = 0
                self._episode_fps = []
            return None

        self.consecutive += 1
        self.anomalies_total += 1
        self._episode_fps.extend(rec["fps"])
        cause = CAUSE_NAMES.get(code, f"code_{code}")
        payload = {
            "step": rec["step"],
            "detected_at": detected_at,
            "code": code,
            "cause": cause,
            "consecutive": self.consecutive,
        }
        for key in ("loss", "grad_norm", "loss_scale"):
            if rec[key] is not None:
                try:
                    payload[key] = self.read_fn(rec[key])
                except (TypeError, ValueError):
                    pass
        if self.telemetry is not None:
            self.telemetry.emit("anomaly", dict(payload), step=rec["step"])
        logger.warning(f"[stability] anomaly at step {rec['step']} ({cause}), "
                       f"streak {self.consecutive}")

        cfg = self.config
        action = ACTION_SKIP
        if (cfg.rollback_after > 0 and self.consecutive >= cfg.rollback_after
                and self.auto_rollbacks < cfg.max_auto_rollbacks):
            action = ACTION_ROLLBACK
        elif (cfg.lr_backoff_after > 0
              and self.consecutive >= cfg.lr_backoff_after
              and (self.consecutive - cfg.lr_backoff_after) % cfg.lr_backoff_after == 0
              and self.lr_backoffs < cfg.max_lr_backoffs):
            action = ACTION_LR_BACKOFF
        return {"action": action, **payload}

    def note_lr_backoff(self):
        self.lr_backoffs += 1

    def after_rollback(self, candidate_fps: Sequence[str], step: int) -> List[str]:
        """Bookkeeping once the engine's checkpoint load succeeded -> the
        newly quarantined fingerprints."""
        added = self.quarantine(candidate_fps, step)
        self.auto_rollbacks += 1
        self.reset_episode()
        return added

    def reset_episode(self):
        """Forget the in-flight boundary and the anomaly streak (they belong
        to a trajectory that no longer exists)."""
        self._pending = None
        self.consecutive = 0
        self._episode_fps = []

    # -- checkpoint round trip -------------------------------------------- #
    def state_dict(self) -> Dict[str, Any]:
        return {
            "quarantine": [[fp, s] for fp, s in self._quarantined.items()],
            "ring": list(self.ring),
            "lr_backoffs": self.lr_backoffs,
            "auto_rollbacks": self.auto_rollbacks,
            "anomalies_total": self.anomalies_total,
        }

    def load_state_dict(self, sd: Optional[Dict[str, Any]]):
        """Restore from a checkpoint's entry.  The quarantine set unions (a
        rollback must not forget what it just quarantined) and
        ``auto_rollbacks`` never decreases (the saved value predates the
        rollback that loaded it)."""
        sd = sd or {}
        for fp, s in sd.get("quarantine", []):
            if fp not in self._quarantined:
                self._quarantined[str(fp)] = int(s)
        self.ring.clear()
        for rec in sd.get("ring", []):
            self.ring.append(rec)
        self.lr_backoffs = int(sd.get("lr_backoffs", self.lr_backoffs))
        self.auto_rollbacks = max(self.auto_rollbacks, int(sd.get("auto_rollbacks", 0)))
        self.anomalies_total = int(sd.get("anomalies_total", self.anomalies_total))
        self.reset_episode()
