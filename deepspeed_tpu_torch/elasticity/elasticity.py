"""Elastic batch-size / device-count solver (the port's own copy of
``deepspeed_tpu/elasticity/elasticity.py``: the same solver, the same
answers).

Reference semantics: ``deepspeed/elasticity/elasticity.py`` —
``compute_elastic_config:233`` with v0.1 (``:83``) and v0.2 (``:126``,
adds model-parallel + chips-per-host divisibility).  Pure math, no device
code: given ``max_train_batch_size`` and candidate ``micro_batch_sizes``,
find the total batch size compatible with the largest set of chip counts,
so the scheduler may scale the job up/down without changing convergence
(global batch = micro x grad_accum x dp_world stays fixed).

The "gpu count" is the number of ranks, one process a GPU
(``launcher/launch.py``), and ``num_gpus_per_node`` the GPUs of a host;
v0.2's node granularity is host granularity.
"""

import math
import os
import json
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger

LATEST_ELASTICITY_VERSION = 0.2
DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"

# highly composite numbers — scaling factors that maximize divisor count
# (same classic sequence the reference uses; supports batch sizes to 720K)
_HCN = [1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260,
        1680, 2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360,
        50400, 55440, 83160, 110880, 166320, 221760, 277200, 332640, 498960,
        554400, 665280, 720720]


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    """Config block (reference ``elasticity/config.py``)."""

    def __init__(self, d: Dict):
        self.enabled = d.get("enabled", False)
        if "max_train_batch_size" not in d:
            raise ElasticityConfigError("max_train_batch_size is required in elasticity config")
        if "micro_batch_sizes" not in d:
            raise ElasticityConfigError("micro_batch_sizes is required in elasticity config")
        self.max_acceptable_batch_size = int(d["max_train_batch_size"])
        self.micro_batches = [int(m) for m in d["micro_batch_sizes"]]
        if not self.micro_batches or any(m <= 0 for m in self.micro_batches):
            raise ElasticityConfigError(f"micro_batch_sizes must be positive: {self.micro_batches}")
        self.min_gpus = int(d.get("min_gpus", 1))
        self.max_gpus = int(d.get("max_gpus", -1))
        if self.min_gpus < 1 or (self.max_gpus != -1 and self.max_gpus < self.min_gpus):
            raise ElasticityConfigError(f"bad min/max gpus: {self.min_gpus}/{self.max_gpus}")
        self.model_parallel_size = int(d.get("model_parallel_size", 1))
        self.num_gpus_per_node = int(d.get("num_gpus_per_node", 1))
        self.min_time = d.get("min_time", 0)
        self.version = float(d.get("version", 0.2))
        self.prefer_larger_batch_size = d.get("prefer_larger_batch_size", True)
        self.ignore_non_elastic_batch_info = d.get("ignore_non_elastic_batch_info", False)


def _candidate_batch_sizes(bases: List[int], max_batch: int) -> List[int]:
    """Scale each base by the largest highly-composite factor keeping the
    product <= max_batch (maximizes the divisor structure of the result)."""
    out = set()
    for b in bases:
        if b >= max_batch:
            out.add(b)
            continue
        limit = max_batch // b
        factor = max(h for h in _HCN if h <= limit)
        out.add(factor * b)
    return sorted(out)


def _valid_gpu_counts(batch: int, micro_batches: List[int], lo: int, hi: int) -> List[int]:
    """All chip counts g in [lo, hi] such that some micro batch divides
    batch/g exactly (i.e. batch = micro x gas x g for integer gas)."""
    valid = set()
    for mb in micro_batches:
        if batch % mb:
            continue
        total = batch // mb          # = g * gas
        for g in range(lo, min(hi, total) + 1):
            if total % g == 0:
                valid.add(g)
    return sorted(valid)


def _solve_v01(micro_batches: List[int], max_batch: int, min_gpus: int,
               max_gpus: int, prefer_larger: bool) -> Tuple[int, List[int]]:
    if any(mb > max_batch for mb in micro_batches):
        raise ElasticityError(
            f"all micro batches {micro_batches} must be <= max_train_batch_size {max_batch}")
    lcm = micro_batches[0]
    for mb in micro_batches[1:]:
        lcm = lcm * mb // math.gcd(lcm, mb)
    candidates = _candidate_batch_sizes(list(micro_batches) + [lcm], max_batch)
    best_batch, best_valid = min(micro_batches), []
    for batch in candidates:
        valid = _valid_gpu_counts(batch, micro_batches, min_gpus, max_gpus)
        better = (len(valid) > len(best_valid)
                  or (len(valid) == len(best_valid)
                      and ((prefer_larger and batch > best_batch)
                           or (not prefer_larger and batch < best_batch))))
        if better:
            best_batch, best_valid = batch, valid
    return best_batch, best_valid


def _solve_v02(micro_batches, max_batch, current_num_gpus, min_gpus, max_gpus,
               prefer_larger, num_gpus_per_node, model_parallel_size):
    """Node-granular variant: chips come in whole hosts; MP divides a host."""
    if num_gpus_per_node % model_parallel_size != 0:
        raise ElasticityError(
            f"chips per host ({num_gpus_per_node}) must be divisible by "
            f"model_parallel_size ({model_parallel_size})")
    dp_per_node = num_gpus_per_node // model_parallel_size

    def pick_micro(batch):
        chosen = None
        for mb in micro_batches:
            if (batch // current_num_gpus) % mb == 0:
                if chosen is None or (prefer_larger and mb > chosen):
                    chosen = mb
        return chosen

    node_batch, node_counts = _solve_v01(
        micro_batches, int(max_batch / dp_per_node),
        max(int(min_gpus / num_gpus_per_node), 1),
        max(int(max_gpus / num_gpus_per_node), 1), prefer_larger)
    batch = int(node_batch) * dp_per_node
    valid_dp = [n * dp_per_node for n in node_counts]
    if current_num_gpus // model_parallel_size in valid_dp:
        return batch, valid_dp, pick_micro(batch)

    # current world size not in the elastic set: fit a batch to it exactly
    current_dp = (current_num_gpus / num_gpus_per_node) * dp_per_node
    fitted = [int(math.floor(max_batch / (mb * current_dp))) * mb * current_dp
              for mb in micro_batches]
    batch = int(max(fitted) if prefer_larger else min(fitted))
    return batch, [int(current_dp)], pick_micro(batch)


def elasticity_enabled(ds_config: Dict) -> bool:
    return ds_config.get("elasticity", {}).get("enabled", False)


def ensure_immutable_elastic_config(runtime_config: Dict):
    """Cross-check the scheduler's view against runtime (reference ``:208``)."""
    if DEEPSPEED_ELASTICITY_CONFIG in os.environ:
        sched = ElasticityConfig(json.loads(os.environ[DEEPSPEED_ELASTICITY_CONFIG]))
        run = ElasticityConfig(runtime_config)
        for field in ("max_acceptable_batch_size", "micro_batches", "version"):
            if getattr(sched, field) != getattr(run, field):
                raise ElasticityConfigError(
                    f"elastic config '{field}' differs between scheduler "
                    f"({getattr(sched, field)}) and runtime ({getattr(run, field)})")
    else:
        logger.warning("DEEPSPEED_ELASTICITY_CONFIG not set; scheduler may scale "
                       "with incompatible chip counts")


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "0.0",
                           world_size: int = 0, return_microbatch: bool = False):
    """Main entry (reference ``compute_elastic_config:233``): returns
    (final_batch_size, valid_gpus[, micro_batch])."""
    if not isinstance(ds_config, dict):
        raise ValueError(f"expected dict config, got {type(ds_config)}")
    if "elasticity" not in ds_config:
        raise ElasticityConfigError("'elasticity' block missing from config")
    cfg = ElasticityConfig(ds_config["elasticity"])
    if not cfg.enabled:
        raise ElasticityConfigError("elasticity is not enabled in config")
    max_gpus = cfg.max_gpus if cfg.max_gpus != -1 else (
        cfg.max_acceptable_batch_size // min(cfg.micro_batches))

    micro = None
    if cfg.version >= 0.2:
        current = world_size if world_size > 0 else cfg.num_gpus_per_node
        batch, valid, micro = _solve_v02(
            cfg.micro_batches, cfg.max_acceptable_batch_size, current,
            cfg.min_gpus, max_gpus, cfg.prefer_larger_batch_size,
            cfg.num_gpus_per_node, cfg.model_parallel_size)
    else:
        batch, valid = _solve_v01(cfg.micro_batches, cfg.max_acceptable_batch_size,
                                  cfg.min_gpus, max_gpus, cfg.prefer_larger_batch_size)
        if world_size > 0:
            if world_size not in valid:
                raise ElasticityIncompatibleWorldSize(
                    f"world size {world_size} not in valid set {valid}")
            for mb in sorted(cfg.micro_batches,
                             reverse=cfg.prefer_larger_batch_size):
                if (batch // world_size) % mb == 0:
                    micro = mb
                    break
    if return_microbatch:
        return batch, valid, micro
    return batch, valid
