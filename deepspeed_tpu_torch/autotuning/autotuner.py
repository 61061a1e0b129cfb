"""Autotuner: find the fastest ZeRO stage + micro-batch combination
(counterpart of ``deepspeed_tpu/autotuning/autotuner.py``: the same tuning
spaces, experiment configs, pruning and outputs).

Reference: ``deepspeed/autotuning/autotuner.py:42``.  Estimate the state
bytes of each ZeRO stage to prune infeasible spaces
(``runtime/memory_model.py:stage_state_bytes``, the arithmetic the offload
planner's budget gate uses), enumerate experiment configs from per-stage
tuning spaces, let a tuner (grid / random / model-based) order the runs,
record results, and write ``ds_config_optimal.json`` and ``summary.txt``.
Experiments run through the ``ResourceManager`` (one subprocess per
experiment; the engine drops ``metrics.json`` at its ``steps_per_print``
boundaries) or an in-process ``run_fn``.  The launcher's
``--autotuning tune|run`` drives it (``launcher/runner.py``).
"""

import copy
import json
import os
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.autotuning.tuner import (GridSearchTuner, ModelBasedTuner,
                                                  RandomTuner)
from deepspeed_tpu_torch.autotuning.utils import gen_combinations
from deepspeed_tpu_torch.runtime import memory_model
from deepspeed_tpu_torch.utils.logging import log_dist

DEFAULT_MIN_MBS = 1
DEFAULT_TUNER = "gridsearch"
TUNERS = {"gridsearch": GridSearchTuner, "random": RandomTuner,
          "model_based": ModelBasedTuner}


class Autotuner:

    def __init__(self, config: Dict, run_fn: Optional[Callable] = None,
                 resource_manager=None, model_info: Optional[Dict] = None,
                 device_memory_bytes: Optional[int] = None,
                 dp_world: int = 1, results_dir: str = "autotuning_results"):
        """``run_fn(exp_config) -> Optional[float]`` overrides subprocess
        execution (tests / in-process tuning); otherwise experiments go
        through ``resource_manager.run_experiment``."""
        self.user_config = copy.deepcopy(config)
        at = dict(config.get("autotuning", {}))
        self.metric = at.get("metric", "throughput")
        self.tuner_type = at.get("tuner_type", DEFAULT_TUNER)
        self.tuner_early_stopping = at.get("tuner_early_stopping", 5)
        self.tuner_num_trials = at.get("tuner_num_trials", 50)
        self.max_train_batch_size = at.get("max_train_batch_size")
        self.mbs_list = at.get("micro_batch_sizes")           # user override
        self.zero_stages = at.get("zero_stages")              # user override
        self.overwrite = at.get("overwrite", True)
        self.results_dir = results_dir
        self.rm = resource_manager
        self._run_fn = run_fn
        self.model_info = model_info or at.get("model_info") or {}
        self.device_memory_bytes = device_memory_bytes
        self.dp_world = max(int(dp_world), 1)
        self.records: Dict[str, List] = {}
        self.best_exp: Optional[Dict] = None
        self.best_metric_val = float("-inf")
        os.makedirs(results_dir, exist_ok=True)

    # -- memory model (reference get_instantiation_memory_required_per_gpu) #
    def get_instantiation_memory_required_per_device(self, stage: int) -> int:
        """Bytes of parameter+optimizer state per device at a ZeRO stage:
        bf16 params (2P) + fp32 masters (4P) + Adam m/v (8P), with the
        stage's sharding: stage>=1 shards optimizer+masters, stage>=3 also
        params.  Gradients (4P fp32 accumulators, sharded at stage>=2) are
        included; activations are workload-dependent and probed, not
        estimated.  The arithmetic lives in ``runtime/memory_model.py`` —
        the SAME model behind ``offload/policy.py:plan_residency``, so the
        bytes pruned on are the bytes the engine's budget gate enforces."""
        p = int(self.model_info.get("num_params", 0))
        return memory_model.stage_state_bytes(p, stage, self.dp_world)

    def _feasible_stages(self) -> List[int]:
        stages = self.zero_stages or [0, 1, 2, 3]
        if not self.device_memory_bytes or not self.model_info.get("num_params"):
            return list(stages)
        out = []
        for s in stages:
            need = self.get_instantiation_memory_required_per_device(s)
            if need < self.device_memory_bytes:
                out.append(s)
            else:
                log_dist(f"autotuning: ZeRO stage {s} pruned "
                         f"(needs {need >> 20} MiB of {self.device_memory_bytes >> 20})",
                         ranks=[0])
        return out or [max(stages)]

    # -- tuning spaces --------------------------------------------------- #
    def _micro_batch_candidates(self) -> List[int]:
        if self.mbs_list:
            return list(self.mbs_list)
        out, m = [], DEFAULT_MIN_MBS
        limit = self.max_train_batch_size or 64
        while m <= limit:
            out.append(m)
            m *= 2
        return out

    def tuning_space(self, stage: int) -> Dict:
        space = {
            "train_micro_batch_size_per_gpu": self._micro_batch_candidates(),
            "zero_optimization": {"stage": stage},
        }
        if stage >= 3:
            # offload on/off is the big stage-3 lever (pinned host memory)
            space["zero_optimization"]["offload_param"] = [
                None, {"device": "cpu"}]
        return space

    def _experiments(self, stage: int) -> List[Dict]:
        exps = []
        for combo in gen_combinations(self.tuning_space(stage)):
            cfg = copy.deepcopy(self.user_config)
            cfg.pop("autotuning", None)
            mbs = combo.pop("train_micro_batch_size_per_gpu")
            cfg["train_micro_batch_size_per_gpu"] = mbs
            gas = cfg.get("gradient_accumulation_steps", 1)
            cfg["train_batch_size"] = mbs * gas * self.dp_world
            zo = dict(cfg.get("zero_optimization", {}))
            for k, v in combo.get("zero_optimization", {}).items():
                if v is not None:
                    zo[k] = v
                else:
                    zo.pop(k, None)
            cfg["zero_optimization"] = zo
            if (self.max_train_batch_size
                    and cfg["train_batch_size"] > self.max_train_batch_size):
                continue
            exps.append(cfg)
        return exps

    # -- execution ------------------------------------------------------- #
    def _run_exp(self, exp_cfg: Dict) -> Optional[float]:
        if self._run_fn is not None:
            return self._run_fn(exp_cfg)
        assert self.rm is not None, "need run_fn or a ResourceManager"
        stage = exp_cfg.get("zero_optimization", {}).get("stage", 0)
        mbs = exp_cfg.get("train_micro_batch_size_per_gpu", 0)
        name = f"z{stage}_mbs{mbs}_{len(self.rm.finished_experiments)}"
        return self.rm.run_experiment(name, exp_cfg)

    def tune(self) -> Optional[Dict]:
        """Search every feasible stage's space; returns the best config."""
        for stage in self._feasible_stages():
            exps = self._experiments(stage)
            if not exps:
                continue
            tuner_cls = TUNERS.get(self.tuner_type, GridSearchTuner)
            tuner = tuner_cls(exps, self._run_exp, metric=self.metric)
            best, val = tuner.tune(sample_size=1,
                                   n_trials=self.tuner_num_trials,
                                   early_stopping=self.tuner_early_stopping)
            self.records[f"z{stage}"] = tuner.records
            log_dist(f"autotuning: stage {stage} best {self.metric}={val}",
                     ranks=[0])
            if best is not None and val > self.best_metric_val:
                self.best_metric_val = val
                self.best_exp = best
        if self.best_exp is not None:
            self.write_optimal_config()
        return self.best_exp

    def write_optimal_config(self):
        path = os.path.join(self.results_dir, "ds_config_optimal.json")
        with open(path, "w") as f:
            json.dump(self.best_exp, f, indent=2)
        summary = os.path.join(self.results_dir, "summary.txt")
        with open(summary, "w") as f:
            f.write(f"best {self.metric}: {self.best_metric_val}\n"
                    f"optimal config: {path}\n")
        log_dist(f"autotuning: optimal config written to {path}", ranks=[0])
