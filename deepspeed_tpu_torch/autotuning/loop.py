"""The closed loop: enumerate → prune analytically → trial → score → emit
(counterpart of ``deepspeed_tpu/autotuning/loop.py``, the same loop,
pruning and artifacts).

:class:`ClosedLoopAutotuner` drives one tuning run end to end:

1. **Enumerate** the typed search space (``space.py``) into candidate
   patches over the modern knobs.
2. **Prune analytically** with the unified memory model
   (``runtime/memory_model.py:analytic_step_peaks`` and
   ``stage_state_bytes``) — the SAME arithmetic the offload planner's
   budget gate enforces at engine init, so a config pruned here is one the
   engine would have refused (or run out of memory on) anyway.  Pruned
   candidates are recorded with their reason and are provably never
   launched (no trial dir, no subprocess).
3. **Trial** every surviving candidate through the
   :class:`~deepspeed_tpu_torch.autotuning.scheduler.TrialScheduler` — short
   profiled subprocess runs with a hang watchdog; wedged or crashed
   trials score degraded and the search moves on.
4. **Score** each trial from its ``EFFICIENCY.json`` goodput ledger
   (``scoring.py``): goodput_frac first, mfu second, step time as the
   tie-break.  ``tuner_early_stopping`` consecutive non-improving
   trials end the search early; ``tuner_num_trials`` caps it.
5. **Emit** a reviewable ``ds_config_patch.json`` (dotted-path diff
   against the base config + environment fingerprint + provenance) and
   a ``manifest.json`` recording every candidate's fate — the report
   CLI (``tools/autotune_report.py``) and the engine's staleness check
   both consume these artifacts.

Config block (all under ``"autotuning"``)::

    {"search_space": {knob: [values...]},       # space.KNOB_CATALOG names
     "model_info": {"num_params": ..., "n_layer": ..., "block_params": ...},
     "device_memory_bytes": ...,                # analytic pruning budget
     "trial": {"steps": 6, "hidden_dim": 64},   # trial.py workload
     "trial_timeout_s": 600, "tuner_num_trials": 50,
     "tuner_early_stopping": 5, "results_dir": "autotuning_results"}
"""

import copy
import json
import os
from typing import Dict, List, Optional

from deepspeed_tpu_torch.autotuning import scheduler as sched_mod
from deepspeed_tpu_torch.autotuning.fingerprint import PATCH_BASENAME, fingerprint_digest
from deepspeed_tpu_torch.autotuning.scheduler import PRUNED, TrialResult, TrialScheduler
from deepspeed_tpu_torch.autotuning.scoring import better
from deepspeed_tpu_torch.autotuning.space import SearchSpace, apply_patch, patch_diff
from deepspeed_tpu_torch.runtime import memory_model
from deepspeed_tpu_torch.utils.logging import log_dist

MANIFEST_BASENAME = "manifest.json"
MANIFEST_SCHEMA = 1


class ClosedLoopAutotuner:
    """Telemetry-scored configuration search over the modern knobs."""

    def __init__(self, base_config: Dict,
                 results_dir: Optional[str] = None,
                 scheduler: Optional[TrialScheduler] = None,
                 trial_env: Optional[Dict[str, str]] = None,
                 world: Optional[int] = None,
                 fingerprint: Optional[Dict] = None):
        self.base_config = copy.deepcopy(base_config)
        at = dict(self.base_config.get("autotuning") or {})
        self.at = at
        self.results_dir = str(results_dir or at.get("results_dir")
                               or "autotuning_results")
        self.space = SearchSpace.from_config(at)
        self.model_info = dict(at.get("model_info") or {})
        self.device_memory_bytes = at.get("device_memory_bytes")
        self.num_trials = int(at.get("tuner_num_trials", 50))
        self.early_stopping = int(at.get("tuner_early_stopping", 5))
        self.world = world
        self._fingerprint = fingerprint
        os.makedirs(self.results_dir, exist_ok=True)
        self.scheduler = scheduler or TrialScheduler(
            os.path.join(self.results_dir, "trials"),
            timeout_s=float(at.get("trial_timeout_s", 600.0)),
            env=dict(trial_env or {}))
        self.pruned: List[TrialResult] = []
        self.trials: List[TrialResult] = []
        self.baseline: Optional[TrialResult] = None
        self.verification: Optional[TrialResult] = None
        self.best: Optional[TrialResult] = None

    # -- analytic pruning -------------------------------------------------- #
    def _candidate_world(self, cand) -> int:
        mesh = cand.patch.get("mesh")
        if isinstance(mesh, dict) and mesh:
            w = 1
            for v in mesh.values():
                w *= int(v)
            return max(w, 1)
        if self.world:
            return max(int(self.world), 1)
        mesh = self.base_config.get("mesh")
        if isinstance(mesh, dict) and mesh:
            w = 1
            for v in mesh.values():
                w *= int(v)
            return max(w, 1)
        return 1

    def prune_reason(self, cand) -> Optional[str]:
        """Why this candidate cannot fit — or ``None`` to run it.

        Uses :func:`memory_model.analytic_step_peaks` (stage 3: gathered
        vs layer-window peak, offload tiers honored) and
        :func:`memory_model.stage_state_bytes` (stages < 3) against the
        HBM budget — the exact model ``offload/policy.plan_residency``
        enforces at trial init, so pruning never disagrees with the
        engine's own refusal gate."""
        p = int(self.model_info.get("num_params") or 0)
        budget = int(cand.knobs.get("hbm_budget_bytes") or 0) \
            or int(self.device_memory_bytes or 0)
        if not p or not budget:
            return None          # nothing to prune on: run the trial
        base_zo = dict(self.base_config.get("zero_optimization") or {})
        stage = int(cand.knobs.get("zero_stage", base_zo.get("stage", 0)))
        world = self._candidate_world(cand)
        if stage < 3:
            need = memory_model.stage_state_bytes(p, stage, world)
            if need > budget:
                return (f"stage {stage} state needs {need} B "
                        f"> budget {budget} B (world={world})")
            return None
        offload_param = cand.knobs.get(
            "offload_param", (base_zo.get("offload_param") or {}).get("device"))
        offload_opt = cand.knobs.get(
            "offload_optimizer",
            (base_zo.get("offload_optimizer") or {}).get("device"))
        peaks = memory_model.analytic_step_peaks(
            p, world,
            block_params=int(self.model_info.get("block_params") or 0),
            n_layer=int(self.model_info.get("n_layer") or 0),
            prefetch_depth=int(cand.knobs.get(
                "prefetch_depth", base_zo.get("prefetch_depth", 2))),
            optimizer_tier=("hbm" if not offload_opt else str(offload_opt)))
        windowed = bool(offload_param) and peaks.has_window
        peak = peaks.window_peak_bytes if windowed else peaks.plain_peak_bytes
        if peak > budget:
            kind = "window" if windowed else "gathered"
            return (f"stage 3 {kind} peak {peak} B > budget {budget} B "
                    f"(world={world})")
        return None

    # -- the loop ---------------------------------------------------------- #
    def tune(self, baseline: bool = False) -> Optional[TrialResult]:
        """Run the closed loop; returns the best scored trial (or None).

        ``baseline=True`` first runs the UNPATCHED base config as trial
        ``baseline`` — it anchors the manifest's improvement claim but
        does not compete for best and does not count against
        ``tuner_num_trials`` / early stopping."""
        candidates = self.space.enumerate()
        log_dist(f"autotuning: closed loop over {len(candidates)} candidates "
                 f"(space: {[k.name for k in self.space.knobs]})", ranks=[0])
        if baseline:
            self.baseline = self.scheduler.run_trial(
                "baseline", copy.deepcopy(self.base_config))
        launched = 0
        since_improve = 0
        for cand in candidates:
            reason = self.prune_reason(cand)
            if reason is not None:
                self.pruned.append(TrialResult(
                    name=cand.cid, status=PRUNED, patch=cand.patch,
                    knobs=cand.knobs, prune_reason=reason))
                log_dist(f"autotuning: {cand.cid} pruned analytically "
                         f"({reason})", ranks=[0])
                continue
            if launched >= self.num_trials:
                log_dist(f"autotuning: tuner_num_trials={self.num_trials} "
                         "reached; stopping", ranks=[0])
                break
            cfg = apply_patch(self.base_config, cand.patch)
            res = self.scheduler.run_trial(cand.cid, cfg,
                                           extra_env=cand.env(),
                                           patch=cand.patch,
                                           knobs=cand.knobs)
            self.trials.append(res)
            launched += 1
            if res.scored and (self.best is None
                               or better(res.score,
                                         self.best.score
                                         if self.best else None)):
                self.best = res
                since_improve = 0
            else:
                since_improve += 1
                if (self.early_stopping
                        and since_improve >= self.early_stopping):
                    log_dist(
                        f"autotuning: {since_improve} consecutive trials "
                        "without improvement "
                        f"(tuner_early_stopping={self.early_stopping}); "
                        "stopping", ranks=[0])
                    break
        self.write_artifacts()
        return self.best

    def verify(self) -> Optional[TrialResult]:
        """Re-run the winning config once as trial ``verify`` — the
        emitted patch's improvement claim is itself measured, not
        assumed.  Re-emits the artifacts with the verification row."""
        if self.best is None:
            return None
        cfg = apply_patch(self.base_config, self.best.patch)
        cand_env = {k[len("env."):]: str(v)
                    for k, v in self.best.patch.items()
                    if k.startswith("env.")}
        self.verification = self.scheduler.run_trial(
            "verify", cfg, extra_env=cand_env, patch=self.best.patch,
            knobs=self.best.knobs)
        self.write_artifacts()
        return self.verification

    # -- artifacts --------------------------------------------------------- #
    def fingerprint(self) -> Dict:
        if self._fingerprint is None:
            from deepspeed_tpu_torch.autotuning.fingerprint import environment_fingerprint
            mesh = self.base_config.get("mesh")
            dims = {k: v for k, v in self.model_info.items()
                    if isinstance(v, (int, float, str))}
            self._fingerprint = environment_fingerprint(
                mesh_shape=mesh if isinstance(mesh, dict) else None,
                model_dims=dims)
        return self._fingerprint

    def manifest(self) -> Dict:
        fp = self.fingerprint()
        return {
            "schema": MANIFEST_SCHEMA,
            "fingerprint": fp,
            "fingerprint_digest": fingerprint_digest(fp),
            "search_space": {k.name: list(k.values)
                             for k in self.space.knobs},
            "counts": {"candidates": len(self.pruned) + len(self.trials),
                       "pruned": len(self.pruned),
                       "run": len(self.trials),
                       "scored": sum(1 for t in self.trials if t.scored),
                       "degraded": sum(1 for t in self.trials
                                       if t.status == sched_mod.DEGRADED)},
            "pruned": [t.as_record() for t in self.pruned],
            "trials": [t.as_record() for t in self.trials],
            "baseline": self.baseline.as_record() if self.baseline else None,
            "verification": (self.verification.as_record()
                             if self.verification else None),
            "best": self.best.as_record() if self.best else None,
        }

    def patch_document(self) -> Optional[Dict]:
        if self.best is None:
            return None
        fp = self.fingerprint()
        return {
            "schema": MANIFEST_SCHEMA,
            "fingerprint": fp,
            "fingerprint_digest": fingerprint_digest(fp),
            "patch": self.best.patch,
            "diff": patch_diff(self.base_config, self.best.patch),
            "score": self.best.score.as_record() if self.best.score else None,
            "provenance": {
                "trial": self.best.name,
                "trial_dir": self.best.trial_dir,
                "manifest": os.path.join(self.results_dir,
                                         MANIFEST_BASENAME),
            },
        }

    def write_artifacts(self) -> Dict[str, str]:
        """Drop ``manifest.json`` (+ ``ds_config_patch.json`` when a
        winner exists) into the results dir; returns the paths."""
        out = {}
        man_path = os.path.join(self.results_dir, MANIFEST_BASENAME)
        with open(man_path, "w") as f:
            json.dump(self.manifest(), f, indent=2, sort_keys=True)
        out["manifest"] = man_path
        doc = self.patch_document()
        if doc is not None:
            patch_path = os.path.join(self.results_dir, PATCH_BASENAME)
            with open(patch_path, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            out["patch"] = patch_path
            log_dist(f"autotuning: best patch written to {patch_path} "
                     f"(goodput_frac="
                     f"{self.best.score.goodput_frac:.3f})", ranks=[0])
        return out
