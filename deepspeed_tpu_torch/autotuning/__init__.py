"""The autotuning plane (counterpart of ``deepspeed_tpu/autotuning/``, the
same names): the seed-era ``Autotuner`` over a ``ResourceManager`` (the
launcher's ``--autotuning tune|run``), and the closed loop
(``ClosedLoopAutotuner``: a typed ``SearchSpace``, analytic pruning, trials
under a reaping ``TrialScheduler``, goodput scoring, ``ds_config_patch.json``
with an environment fingerprint the engine checks at build)."""

from deepspeed_tpu_torch.autotuning.autotuner import Autotuner
from deepspeed_tpu_torch.autotuning.fingerprint import StaleTuningError, environment_fingerprint
from deepspeed_tpu_torch.autotuning.fingerprint import check as check_fingerprint
from deepspeed_tpu_torch.autotuning.fingerprint import check_engine
from deepspeed_tpu_torch.autotuning.loop import ClosedLoopAutotuner
from deepspeed_tpu_torch.autotuning.scheduler import (CONFIG_PATH_ENV, METRIC_PATH_ENV,
                                                      ResourceManager, TrialResult,
                                                      TrialScheduler, write_metrics)
from deepspeed_tpu_torch.autotuning.scoring import TrialScore, better, score_from_efficiency
from deepspeed_tpu_torch.autotuning.space import (KNOB_CATALOG, Candidate, SearchSpace,
                                                  apply_patch, patch_diff)
from deepspeed_tpu_torch.autotuning.tuner import (BaseTuner, GridSearchTuner, ModelBasedTuner,
                                                  RandomTuner, RidgeCostModel)

__all__ = ["Autotuner", "ResourceManager", "write_metrics", "BaseTuner",
           "GridSearchTuner", "RandomTuner", "ModelBasedTuner",
           "RidgeCostModel", "METRIC_PATH_ENV", "CONFIG_PATH_ENV",
           "ClosedLoopAutotuner", "TrialScheduler", "TrialResult",
           "TrialScore", "better", "score_from_efficiency",
           "SearchSpace", "Candidate", "KNOB_CATALOG", "apply_patch",
           "patch_diff", "environment_fingerprint", "check_fingerprint",
           "check_engine", "StaleTuningError"]
