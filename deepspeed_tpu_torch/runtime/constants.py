"""ds_config keys and defaults (counterpart of
``deepspeed_tpu/runtime/constants.py``).

The JSON keys the port's ``DeepSpeedConfig`` reads, with the JAX package's
names and defaults, so a config written for either package parses in both.
"""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"

SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

#############################################
# Precision
#############################################
FP16 = "fp16"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # legacy key accepted by the reference
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# Logging / profiling
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

#############################################
# Parallelism blocks (world size 1 in the port so far)
#############################################
MESH = "mesh"
TENSOR_PARALLEL = "tensor_parallel"
PIPELINE_PARALLEL = "pipeline"
SEQUENCE_PARALLEL = "sequence_parallel"

#############################################
# Sub-configs
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"

#############################################
# Checkpoints: the ``checkpoint`` block and the checkpoint fields of the
# ``fault_tolerance`` block (its ``preemption_*`` fields are item 8)
#############################################
CHECKPOINT = "checkpoint"

FAULT_TOLERANCE = "fault_tolerance"

# Blocks the port parses but whose feature is not ported yet: the engine
# raises when one of them is enabled (ROADMAP.md, Queue 1 items 8 and 9).
STABILITY = "stability"
TELEMETRY = "telemetry"
COMMS_LOGGER = "comms_logger"
MONITOR_CONFIG_TENSORBOARD = "tensorboard"
MONITOR_CONFIG_WANDB = "wandb"
MONITOR_CONFIG_CSV = "csv_monitor"
FLOPS_PROFILER = "flops_profiler"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
EIGENVALUE = "eigenvalue"
QUANTIZE_TRAINING = "quantize_training"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
SPARSE_ATTENTION = "sparse_attention"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = "fixed"
