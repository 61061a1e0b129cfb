"""The DeepSpeed-style JSON config (counterpart of
``deepspeed_tpu/runtime/config.py``).

One JSON document (path or dict) becomes a typed ``DeepSpeedConfig`` with
the batch arithmetic invariant

    train_batch_size = micro_batch_per_device * gradient_accumulation_steps * dp_world_size

solved and validated as the JAX package (and the reference) do, with the
same ``DeepSpeedConfigError`` on inconsistent or missing values.  The
engine passes the data-parallel world size (``WORLD_SIZE``, or the process
group's).  The ``sparse_attention`` block is checked
as the JAX package checks it (``ValueError`` if it is not a dict,
``NotImplementedError`` on an unknown mode) and kept as a dict.  The
``checkpoint``, ``fault_tolerance`` (checkpoints, preemption and the
elastic agent's restart keys) and ``stability`` blocks are typed, with the
JAX defaults, and so is the ``telemetry`` block
(``DeepSpeedTelemetryConfig``: every key of the JAX package's, with its
defaults; ``profiler_dir`` defaults under the temporary directory).  The
``elasticity`` block is kept as the JAX package keeps it (a dict, read by
``comm/recovery.py:RecoveryPolicy.from_config`` and the elastic agent) and
checked here: with ``enabled`` its solver keys must parse
(``elasticity/elasticity.py:ElasticityConfig``), and every key must be one
the solver or the recovery plane reads, so a block is never taken and
ignored.  The ``autotuning`` block is kept as a dict, as the JAX package
keeps it: the engine checks the fingerprint of a tuned patch it names
(``patch`` / ``results_dir``) at build.  Blocks of features the port has
not taken over yet (monitors, PLD, compression, ...) are kept as raw dicts;
the engine raises when one of them is enabled.
"""

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch
from pydantic import Field

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import (DeepSpeedConfigModel,
                                                      dict_raise_error_on_duplicate_keys)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.telemetry.profiler import DEFAULT_PROFILER_DIR
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedFP16Config(DeepSpeedConfigModel):
    """``fp16`` block."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1
    consecutive_hysteresis: bool = False
    fp16_master_weights_and_grads: bool = False


class DeepSpeedBF16Config(DeepSpeedConfigModel):
    enabled: bool = False


class DeepSpeedActivationCheckpointingConfig(DeepSpeedConfigModel):
    """``activation_checkpointing`` block: selects the remat policy of
    ``runtime/activation_checkpointing/checkpointing.py``."""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


class DeepSpeedCheckpointConfig(DeepSpeedConfigModel):
    """``checkpoint`` block: the storage backend of
    ``runtime/checkpoint_engine/`` (``"torch"``, also taken as
    ``"default"`` and ``"orbax"``, or ``"local"``) and async save.  Other
    keys of the JAX block are carried and unused."""
    tag_validation: str = "Warn"
    async_save: bool = False
    engine: str = "orbax"


class DeepSpeedFaultToleranceConfig(DeepSpeedConfigModel):
    """``fault_tolerance`` block: verified atomic checkpoints, load
    rollback and preemption-aware shutdown (``runtime/fault_tolerance.py``),
    with the JAX package's keys and defaults.  The restart keys are the
    elastic agent's (``elasticity/elastic_agent.py`` reads them from the
    ds_config)."""
    atomic_save: bool = True
    keep_last_n: int = 0            # retention window; 0 = keep every tag
    save_retries: int = 3
    retry_backoff_s: float = 0.5
    retry_backoff_max_s: float = 8.0
    verify_on_load: bool = True
    rollback: bool = True
    max_rollback: int = 3           # earlier tags to try past the newest
    # SIGTERM / a cloud probe -> final synchronous checkpoint + exit 143
    preemption_enabled: bool = False
    preemption_save_dir: str = ""   # "" -> the last save_checkpoint dir
    preemption_grace_s: float = 30.0
    preemption_probe: str = ""      # "pkg.mod:callable"
    preemption_poll_s: float = 0.0  # 0 -> signal only (no probe thread)
    restart_backoff_s: float = 1.0
    restart_backoff_max_s: float = 30.0
    restart_jitter: float = 0.2
    stability_window_s: float = 300.0  # uptime that clears restart_count


class DeepSpeedStabilityConfig(DeepSpeedConfigModel):
    """``stability`` block: the training-stability sentinel
    (``runtime/stability.py``), the JAX package's keys and defaults.  The
    detector thresholds are constants of the captured step; the ladder
    runs on the host at the step boundary."""
    enabled: bool = False
    warmup_steps: int = 20          # clean steps before the spike detectors arm
    ema_alpha: float = 0.02         # EW mean / variance decay
    grad_spike_factor: float = 10.0  # grad_norm > factor * EMA -> anomaly
    loss_spike_zscore: float = 8.0  # (loss - EMA) / sigma above this -> anomaly
    scale_collapse_windows: int = 3  # boundaries at min_scale -> anomaly
    skip_anomalous_steps: bool = True  # suppress the update on the device
    lr_backoff_after: int = 3
    lr_backoff_factor: float = 0.5
    max_lr_backoffs: int = 3
    rollback_after: int = 6
    max_auto_rollbacks: int = 2
    rollback_load_dir: str = ""     # "" -> the last save_checkpoint dir
    quarantine: bool = True
    quarantine_ring: int = 64


# the keys of an ``elasticity`` block: the batch solver's
# (``elasticity/elasticity.py``) and the recovery plane's
# (``comm/recovery.py:RecoveryPolicy``)
ELASTICITY_SOLVER_KEYS = ("enabled", "max_train_batch_size", "micro_batch_sizes", "min_gpus",
                          "max_gpus", "model_parallel_size", "num_gpus_per_node", "min_time",
                          "version", "prefer_larger_batch_size",
                          "ignore_non_elastic_batch_info")
ELASTICITY_RECOVERY_KEYS = ("recovery_enabled", "collective_timeout_s", "heartbeat_interval_s",
                            "heartbeat_timeout_s", "max_step_retries", "retry_backoff_s",
                            "min_world_size", "allow_shrink", "allow_restart",
                            "recovery_deadline_s", "rendezvous_dir")


def check_elasticity_block(block: Any) -> Dict[str, Any]:
    """The ``elasticity`` block as a dict, refused (``DeepSpeedConfigError``)
    when it is not a dict, names a key neither the solver nor the recovery
    plane reads, or is enabled with solver keys that do not parse."""
    if block is None:
        return {}
    if not isinstance(block, dict):
        raise DeepSpeedConfigError(f"'{C.ELASTICITY}' must be a dict, got {type(block).__name__}")
    unknown = sorted(set(block) - set(ELASTICITY_SOLVER_KEYS) - set(ELASTICITY_RECOVERY_KEYS))
    if unknown:
        raise DeepSpeedConfigError(f"unknown '{C.ELASTICITY}' keys {unknown}: the port reads "
                                   f"{ELASTICITY_SOLVER_KEYS + ELASTICITY_RECOVERY_KEYS}")
    if block.get("enabled", False):
        from deepspeed_tpu_torch.elasticity.elasticity import (ElasticityConfig,
                                                               ElasticityConfigError)
        try:
            ElasticityConfig(block)
        except ElasticityConfigError as e:
            raise DeepSpeedConfigError(f"'{C.ELASTICITY}' block: {e}") from e
    return dict(block)


# the flight recorder's default dump directory, under TMPDIR as the
# profiler's is (the JAX package's is /tmp/deepspeed_tpu_flight)
DEFAULT_FLIGHT_DIR = os.path.join(tempfile.gettempdir(), "deepspeed_tpu_flight")


class DeepSpeedTelemetryConfig(DeepSpeedConfigModel):
    """``telemetry`` block — the TelemetryHub + profiler-window knobs
    (``telemetry/``), the JAX package's keys and defaults.

    Off by default; when enabled the engine emits one structured record per
    optimizer step and drains them (one device sync) every ``flush_every``
    steps.
    """
    enabled: bool = False
    jsonl_path: str = ""                 # rank-0 JSONL sink ("" disables)
    jsonl_max_bytes: int = 0             # rotate the sink past this (0 → off)
    jsonl_keep: int = 5                  # rotated files kept (beyond live)
    ring_buffer_size: int = 1024         # in-memory sink (0 disables)
    flush_every: int = 0                 # 0 → follow steps_per_print (or 50)
    # live metrics plane
    metrics: bool = True                 # MetricsRegistry fed off the drain
    snapshot_every: int = 0              # cross-rank fold cadence, steps (0 off)
    ops_server: bool = False             # stdlib HTTP /metrics /healthz /slo
    ops_host: str = "127.0.0.1"
    ops_port: int = 0                    # 0 → ephemeral (logged at startup)
    slo_rules: List[Dict[str, Any]] = Field(default_factory=list)
    # empty slo_rules → telemetry/slo.py default_rules(); entries use the
    # rule grammar documented in that module
    # windowed torch.profiler capture over [start, end) global steps
    profiler_start_step: int = 0
    profiler_end_step: int = 0           # 0 → profiler disabled
    profiler_dir: str = Field(default_factory=lambda: DEFAULT_PROFILER_DIR)
    profiler_max_window_steps: int = 64  # unbounded-trace guard
    # span tracing (Chrome-trace export per rank; tools/trace_merge.py
    # folds rank files onto one timeline)
    tracing: bool = False
    trace_dir: str = ""                  # "" → no export on close
    trace_buffer_size: int = 65536       # completed-span ring capacity
    # goodput/efficiency attribution ledger
    goodput: bool = True                 # GoodputLedger on the metrics plane
    efficiency_json_path: str = ""       # "" → EFFICIENCY.json next to jsonl
    # > 0 (JAX's MFU gauge) raises: it needs the flops profiler, not ported
    goodput_peak_tflops_per_chip: float = 0.0
    # collective health plane: per-rank seq/fingerprint ring on comm/ +
    # cross-rank skew/desync fold at snapshot_every cadence
    collective_monitor: bool = True      # rides the metrics plane
    collective_ring: int = 2048          # per-rank record ring capacity
    # hang watchdog + flight recorder
    watchdog_enabled: bool = False
    watchdog_timeout_s: float = 120.0    # stall threshold (monotonic)
    watchdog_poll_s: float = 0.0         # 0 → timeout/4, clamped [0.5, 10]s
    watchdog_signal_dump: bool = True    # dump on SIGTERM/SIGABRT too
    flight_recorder_dir: str = Field(default_factory=lambda: DEFAULT_FLIGHT_DIR)


class DeepSpeedConfigError(Exception):
    pass


# blocks whose feature is not ported: {"enabled": true} in one of them makes
# the engine raise, naming the ROADMAP item
UNPORTED_BLOCKS = {
    C.COMMS_LOGGER: "ROADMAP.md, Queue 1 item 7 (comms)",
    C.MONITOR_CONFIG_TENSORBOARD: "ROADMAP.md, Queue 1 item 9 (monitor)",
    C.MONITOR_CONFIG_WANDB: "ROADMAP.md, Queue 1 item 9 (monitor)",
    C.MONITOR_CONFIG_CSV: "ROADMAP.md, Queue 1 item 9 (monitor)",
    C.FLOPS_PROFILER: "ROADMAP.md, Queue 1 item 9 (flops profiler)",
    C.PROGRESSIVE_LAYER_DROP: "ROADMAP.md, Queue 1 item 9 (progressive layer drop)",
    C.EIGENVALUE: "ROADMAP.md, Queue 1 item 9 (compression / MoQ)",
    C.QUANTIZE_TRAINING: "ROADMAP.md, Queue 1 item 9 (compression / MoQ)",
    C.DATA_EFFICIENCY: "ROADMAP.md, Queue 1 item 9 (data pipeline)",
    C.CURRICULUM_LEARNING_LEGACY: "ROADMAP.md, Queue 1 item 9 (data pipeline)",
}


class DeepSpeedConfig:
    """Parses and validates the full ds_config JSON document; the attribute
    names are the JAX package's (and the reference's)."""

    def __init__(self, config: Any, world_size: int = 1):
        if isinstance(config, (str, os.PathLike)):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"DeepSpeed config path does not exist: {config}")
            with open(config) as f:
                self._param_dict = json.load(f,
                                             object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        elif isinstance(config, DeepSpeedConfig):
            self._param_dict = dict(config._param_dict)
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path or dict for the DeepSpeed config, got {type(config)}")
        self.world_size = world_size
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _initialize_params(self, pd: Dict):
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                                                     C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(C.GRADIENT_ACCUMULATION_STEPS,
                                                  C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self._raw_batch = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                           self.gradient_accumulation_steps)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = pd.get(C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        opt = pd.get(C.OPTIMIZER, None)
        self.optimizer_name = opt.get(C.TYPE).lower() if opt and opt.get(C.TYPE) else None
        self.optimizer_params = (opt or {}).get(C.OPTIMIZER_PARAMS, {})

        sched = pd.get(C.SCHEDULER, None)
        self.scheduler_name = sched.get(C.TYPE) if sched else None
        self.scheduler_params = (sched or {}).get(C.SCHEDULER_PARAMS, {})

        self.zero_config = DeepSpeedZeroConfig(**pd.get(C.ZERO_OPTIMIZATION, {}))

        self.fp16_config = DeepSpeedFP16Config(**pd.get(C.FP16, {}))
        self.bfloat16_config = DeepSpeedBF16Config(**pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {})))
        self.amp_enabled = bool(pd.get(C.AMP, {}).get(C.AMP_ENABLED, C.AMP_ENABLED_DEFAULT))
        self.activation_checkpointing_config = DeepSpeedActivationCheckpointingConfig(
            **pd.get(C.ACTIVATION_CHECKPOINTING, {}))

        self.checkpoint_config = DeepSpeedCheckpointConfig(**pd.get(C.CHECKPOINT, {}))
        self.fault_tolerance_config = DeepSpeedFaultToleranceConfig(
            **pd.get(C.FAULT_TOLERANCE, {}))
        self.telemetry_config = DeepSpeedTelemetryConfig(**pd.get(C.TELEMETRY, {}))
        self.stability_config = DeepSpeedStabilityConfig(**pd.get(C.STABILITY, {}))
        self.elasticity_config = check_elasticity_block(pd.get(C.ELASTICITY, None))

        self.parallel_blocks = {k: pd.get(k, {}) for k in (
            C.MESH, C.TENSOR_PARALLEL, C.PIPELINE_PARALLEL, C.SEQUENCE_PARALLEL)}
        # validated eagerly so that a typo fails here; a model builds its
        # SparsityConfig from the block with sparsity_config_from_dict
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION, None)
        if self.sparse_attention is not None:
            from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
                validate_sparsity_mode)
            if not isinstance(self.sparse_attention, dict):
                raise ValueError(f"'{C.SPARSE_ATTENTION}' must be a dict, "
                                 f"got {type(self.sparse_attention).__name__}")
            validate_sparsity_mode(self.sparse_attention.get(C.SPARSE_MODE, C.SPARSE_MODE_DEFAULT))
        self.compression_config = pd.get(C.COMPRESSION_TRAINING, {})
        # kept as the JAX config keeps it; the engine checks a tuned patch's
        # fingerprint at build (autotuning/fingerprint.py:check_engine)
        self.autotuning_config = pd.get(C.AUTOTUNING, {})
        self.unported_blocks = {k: pd.get(k, {}) for k in UNPORTED_BLOCKS}

    @property
    def dp_world_size(self) -> int:
        """Data-parallel replicas: devices not taken by model axes."""
        mesh = self.parallel_blocks[C.MESH]
        tp = max(int(self.parallel_blocks[C.TENSOR_PARALLEL].get("tp_size", 1)),
                 int(mesh.get("tensor", 1)), 1)
        pp = max(int(self.parallel_blocks[C.PIPELINE_PARALLEL].get("stages", 1)),
                 int(mesh.get("pipe", 1)), 1)
        sp = max(int(self.parallel_blocks[C.SEQUENCE_PARALLEL].get("sp_size", 1)),
                 int(mesh.get("seq", 1)), 1)
        model_degree = tp * pp * sp
        if self.world_size % model_degree:
            raise DeepSpeedConfigError(
                f"world size {self.world_size} not divisible by tp*pp*sp={model_degree}")
        return self.world_size // model_degree

    def resolve_batch_size(self, world_size: int):
        """Solve the batch arithmetic again for another world size (a mesh
        shrink), from the values the config gave."""
        if world_size == self.world_size:
            return
        self.world_size = world_size
        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = self._raw_batch
        self._configure_train_batch_size()

    def _configure_train_batch_size(self):
        """Solve/validate train_batch = micro * gas * dp_world."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = self.dp_world_size

        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
        elif train is not None and gas is not None:
            micro = train // (dp * gas)
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas = 1
            micro = train // dp
        elif micro is not None:
            train = micro * dp
            gas = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

        if train != micro * gas * dp:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step * world_size: "
                f"{train} != {micro} * {gas} * {dp}")
        if micro is None or micro <= 0 or (gas is None or gas <= 0):
            raise DeepSpeedConfigError(
                f"Batch arithmetic produced non-positive values: micro={micro}, gas={gas}")

    def _do_sanity_check(self):
        if self.fp16_config.enabled and self.bfloat16_config.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot both be enabled")
        if self.optimizer_name is None and self.scheduler_name is not None:
            logger.warning("scheduler configured without an optimizer block; "
                           "the default Adam takes the schedule")

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.fp16_config.enabled:
            return torch.float16
        if self.bfloat16_config.enabled:
            return torch.bfloat16
        return torch.float32
