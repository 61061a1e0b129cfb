"""Experiment tuners: grid, random, and cost-model-guided search
(counterpart of ``deepspeed_tpu/autotuning/tuner.py``, the same tuners in
numpy: a seeded ``RandomTuner`` and a ``ModelBasedTuner`` over the
``RidgeCostModel``).

Reference: ``deepspeed/autotuning/tuner/{base_tuner,index_based_tuner,
model_based_tuner,cost_model}.py``.  The reference's model-based tuner
fits an XGBoost ranker; the cost model here is a ridge regressor over the
same flattened-config features — the role (rank untried configs, try the
promising ones first) is identical.
"""

import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.autotuning.utils import dict_to_feature, flatten


class RidgeCostModel:
    """Least-squares surrogate: predicts the metric from config features
    (the ``XGBoostCostModel`` slot, ``tuner/cost_model.py:14``)."""

    def __init__(self, l2: float = 1e-3):
        self.l2 = l2
        self.w: Optional[np.ndarray] = None

    def fit(self, xs: List[List[float]], ys: List[float]):
        x = np.asarray(xs, np.float64)
        y = np.asarray(ys, np.float64)
        y_max = max(float(np.max(np.abs(y))), 1e-9)
        y = y / y_max
        self._y_max = y_max
        x = np.concatenate([x, np.ones((len(x), 1))], axis=1)   # bias
        a = x.T @ x + self.l2 * np.eye(x.shape[1])
        self.w = np.linalg.solve(a, x.T @ y)

    def predict(self, xs: List[List[float]]) -> np.ndarray:
        x = np.asarray(xs, np.float64)
        x = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        return x @ self.w * self._y_max


class BaseTuner:
    """Iterate experiments, track the best (reference ``base_tuner.py:13``).

    ``run_fn(exp) -> Optional[float]`` executes one experiment and returns
    the metric value (higher is better; None/exception = failed run).
    """

    def __init__(self, exps: List[Dict], run_fn: Callable[[Dict], Optional[float]],
                 metric: str = "throughput"):
        self.all_exps = list(exps)
        self.rm_exps = list(exps)
        self.run_fn = run_fn
        self.metric = metric
        self.best_exp: Optional[Dict] = None
        self.best_metric_val: float = float("-inf")
        self.records: List[Tuple[Dict, Optional[float]]] = []

    def has_next(self) -> bool:
        return len(self.rm_exps) > 0

    def next_batch(self, sample_size: int = 1) -> List[Dict]:
        raise NotImplementedError

    def update(self):
        """Hook after each batch of results (model refit etc.)."""

    def tune(self, sample_size: int = 1, n_trials: int = 1000,
             early_stopping: Optional[int] = None) -> Tuple[Optional[Dict], float]:
        trials = 0
        since_best = 0
        while self.has_next() and trials < n_trials:
            batch = self.next_batch(sample_size)
            for exp in batch:
                try:
                    val = self.run_fn(exp)
                except Exception:
                    val = None
                self.records.append((exp, val))
                trials += 1
                if val is not None and val > self.best_metric_val:
                    self.best_metric_val = val
                    self.best_exp = exp
                    since_best = 0
                else:
                    since_best += 1
            self.update()
            if early_stopping and since_best >= early_stopping:
                break
        return self.best_exp, self.best_metric_val


class GridSearchTuner(BaseTuner):
    def next_batch(self, sample_size: int = 1) -> List[Dict]:
        batch = self.rm_exps[:sample_size]
        self.rm_exps = self.rm_exps[sample_size:]
        return batch


class RandomTuner(BaseTuner):
    def __init__(self, exps, run_fn, metric: str = "throughput", seed: int = 0):
        super().__init__(exps, run_fn, metric)
        self._rng = random.Random(seed)

    def next_batch(self, sample_size: int = 1) -> List[Dict]:
        k = min(sample_size, len(self.rm_exps))
        batch = self._rng.sample(self.rm_exps, k)
        for b in batch:
            self.rm_exps.remove(b)
        return batch


class ModelBasedTuner(BaseTuner):
    """Cost-model-guided search (reference ``model_based_tuner.py:19``):
    warm up randomly, then repeatedly propose the untried configs the
    surrogate ranks highest."""

    def __init__(self, exps, run_fn, metric: str = "throughput",
                 warmup: int = 3, seed: int = 0):
        super().__init__(exps, run_fn, metric)
        self.warmup = warmup
        self._rng = random.Random(seed)
        self.keys = sorted({k for e in exps for k in flatten(e)})
        self.model = RidgeCostModel()
        self._trained = False

    def _feat(self, exp: Dict) -> List[float]:
        return dict_to_feature(flatten(exp), self.keys)

    def next_batch(self, sample_size: int = 1) -> List[Dict]:
        evaluated = len(self.records)
        if evaluated < self.warmup or not self._trained:
            k = min(sample_size, len(self.rm_exps))
            batch = self._rng.sample(self.rm_exps, k)
        else:
            preds = self.model.predict([self._feat(e) for e in self.rm_exps])
            order = np.argsort(-preds)[:sample_size]
            batch = [self.rm_exps[i] for i in order]
        for b in batch:
            self.rm_exps.remove(b)
        return batch

    def update(self):
        xs = [self._feat(e) for e, v in self.records if v is not None]
        ys = [v for _, v in self.records if v is not None]
        if len(xs) >= 2:
            self.model.fit(xs, ys)
            self._trained = True
