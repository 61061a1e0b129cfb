"""Trial scoring: rank candidate configs by the goodput ledger (counterpart
of ``deepspeed_tpu/autotuning/scoring.py``, the same score and ranking).

The single scoring input is the per-trial ``EFFICIENCY.json`` artifact
that the port's ledger writes (``telemetry/ledger.py:write_efficiency_json``
— conservation-checked category attribution + ``goodput_frac`` + ``mfu``).
Ranking is ``goodput_frac`` first, ``mfu`` second, mean step time as the
tie-break — so a config that "wins" raw step time by skipping recovery
work, stalling on offload, or burning steps on rollback replay does NOT
look fast: those seconds land in non-productive categories and depress
exactly the fraction being ranked.  In the port's trials ``mfu`` is
``None`` (the MFU gauge needs the flops profiler, not ported:
``telemetry/hub.py`` refuses ``goodput_peak_tflops_per_chip > 0``), so the
ranking falls to ``goodput_frac``, then mean step time.

A ledger that fails its conservation check is mis-instrumented and is
scored as degraded (``conservation_ok=False``) — the closed loop never
crowns it.

Everything here is host-side JSON arithmetic over an artifact already on
disk: nothing touches a device value or imports torch.
"""

import json
import math
from dataclasses import asdict, dataclass
from typing import Optional, Tuple

#: EFFICIENCY.json schema this scorer understands (ledger.SCHEMA_VERSION)
LEDGER_SCHEMA = 1


@dataclass
class TrialScore:
    """The scalarizable view of one trial's ledger."""
    goodput_frac: float
    mfu: Optional[float]
    step_time_s: Optional[float]     # wall / steps — the tie-break only
    wall_s: float
    steps: int
    productive_steps: int
    conservation_ok: bool
    mode: str = "train"

    def as_record(self):
        return asdict(self)

    def rank_key(self) -> Tuple[float, float, float]:
        """Sort key, ascending = better: goodput desc, mfu desc, step
        time asc (unknown step time ranks last among equals)."""
        step = self.step_time_s if self.step_time_s is not None else math.inf
        return (-self.goodput_frac, -(self.mfu or 0.0), step)


def score_from_ledger(led: dict) -> Tuple[Optional[TrialScore], Optional[str]]:
    """A folded/snapshotted ledger dict -> (score, error)."""
    if not isinstance(led, dict) or "categories" not in led:
        return None, "not a ledger document (no categories)"
    try:
        wall = float(led.get("wall_s", 0.0))
        steps = int(led.get("steps", 0))
        gf = led.get("goodput_frac")
        if gf is None:
            return None, "ledger carries no goodput_frac"
        cons = led.get("conservation") or {}
        return TrialScore(
            goodput_frac=float(gf),
            mfu=(float(led["mfu"]) if led.get("mfu") is not None else None),
            step_time_s=(wall / steps) if steps > 0 else None,
            wall_s=wall,
            steps=steps,
            productive_steps=int(led.get("productive_steps", 0)),
            conservation_ok=bool(cons.get("ok", False)),
            mode=str(led.get("mode", "train"))), None
    except (TypeError, ValueError) as e:
        return None, f"malformed ledger: {e}"


def score_from_efficiency(path: str) -> Tuple[Optional[TrialScore],
                                              Optional[str]]:
    """Read one trial's ``EFFICIENCY.json`` -> (score, error).  Accepts
    the artifact envelope (``{"ledger": {...}}``) or a bare ledger."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return None, f"unreadable EFFICIENCY.json {path}: {e}"
    led = doc.get("ledger") if isinstance(doc, dict) and "ledger" in doc \
        else doc
    return score_from_ledger(led)


def better(a: Optional[TrialScore], b: Optional[TrialScore]) -> bool:
    """Is ``a`` a strictly better trial than ``b``?  ``None`` and
    non-conserving scores never beat anything; anything valid beats
    ``None``."""
    if a is None or not a.conservation_ok:
        return False
    if b is None or not b.conservation_ok:
        return True
    return a.rank_key() < b.rank_key()
