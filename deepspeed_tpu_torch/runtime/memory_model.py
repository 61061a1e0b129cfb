"""Per-device state bytes and step peaks (counterpart of
``deepspeed_tpu/runtime/memory_model.py``).

The JAX module's arithmetic, unchanged: ``stage_state_bytes`` (the
autotuner's per-stage state bytes), ``step_peaks`` and
``analytic_step_peaks`` (the residency planner's plain stage-3 and
layer-window peaks).  The port adds ``host_state_bytes``: what its offload
keeps in host memory.  Pure integer arithmetic over counts the caller
supplies.

Conventions (per device, the engine's layout):

* params are held as fp32 masters (``MASTER_ITEMSIZE``) sharded over the
  ranks at stage >= 3, gathered to the compute dtype for the step;
* gradient accumulators are fp32, sharded at stage >= 2;
* optimizer state is ``opt_slots`` fp32 copies of the params (Adam m+v),
  sharded together with the fp32 masters at stage >= 1.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

#: fp32 master / gradient-accumulator / optimizer-slot element size
MASTER_ITEMSIZE = 4
#: default compute dtype element size (bf16)
COMPUTE_ITEMSIZE = 2
#: Adam first+second moment
DEFAULT_OPT_SLOTS = 2


def stage_state_bytes(num_params: int, stage: int, world: int,
                      compute_itemsize: int = COMPUTE_ITEMSIZE,
                      opt_slots: int = DEFAULT_OPT_SLOTS) -> int:
    """Per-device bytes of parameter + gradient + optimizer state at a
    ZeRO stage — the autotuner's pruning arithmetic.

    compute-dtype params (sharded at stage >= 3) + fp32 grad
    accumulators (sharded at stage >= 2) + fp32 masters and
    ``opt_slots`` fp32 moments (sharded at stage >= 1).  Activations are
    workload-dependent and probed by a trial run, never estimated here.
    """
    p = int(num_params)
    world = max(1, int(world))
    params_mem = compute_itemsize * p / (world if stage >= 3 else 1)
    grads_mem = MASTER_ITEMSIZE * p / (world if stage >= 2 else 1)
    opt_mem = (MASTER_ITEMSIZE * (1 + opt_slots) * p
               / (world if stage >= 1 else 1))
    return int(params_mem + grads_mem + opt_mem)


@dataclass
class StepPeaks:
    """Per-device peak bytes of one optimizer step under the two
    residency plans the engine knows how to run."""
    plain_peak_bytes: int       # full gathered tree + shards
    window_peak_bytes: int      # layer-window ring + shards
    shard_bytes: int            # fp32 master shard
    grads_shard_bytes: int      # fp32 grad-accumulator shard
    opt_shard_bytes: int        # optimizer-state shard
    has_window: bool            # model is stacked: a window plan exists
    notes: Tuple[str, ...] = field(default_factory=tuple)


def step_peaks(param_bytes: int,
               gathered_bytes: int,
               world: int,
               opt_bytes: Optional[int] = None,
               opt_slots: int = DEFAULT_OPT_SLOTS,
               block_gathered_bytes: int = 0,
               rest_gathered_bytes: int = 0,
               n_layer: int = 0,
               prefetch_depth: int = 2,
               optimizer_tier: str = "hbm") -> StepPeaks:
    """The residency planner's peak arithmetic (one home, two callers).

    ``param_bytes`` is the fp32 master tree total; ``gathered_bytes`` the
    same tree at the compute dtype.  ``opt_bytes=None`` sizes the
    optimizer as ``opt_slots`` fp32 copies of the param shard.  With a
    stacked model (``n_layer > 0``) the window peak keeps only the
    non-block leaves plus ``prefetch_depth + 1`` per-layer slices
    HBM-resident; ``optimizer_tier != "hbm"`` drops the optimizer shard
    from the window peak entirely (it lives host/NVMe-side).
    """
    world = max(1, int(world))
    notes = []
    shard = int(param_bytes) // world
    grads_shard = int(param_bytes) // world
    if opt_bytes is not None:
        opt_shard = int(opt_bytes) // world
    else:
        opt_shard = opt_slots * shard
        notes.append(f"optimizer sized as {opt_slots}x fp32 param shard")

    # plain stage 3: everything gathered at once + shards + grads + opt
    plain_peak = int(gathered_bytes) + shard + grads_shard + opt_shard

    depth = max(1, int(prefetch_depth))
    has_window = n_layer > 0 and block_gathered_bytes > 0
    if has_window:
        per_slice = int(block_gathered_bytes) // n_layer
        window = (int(rest_gathered_bytes)
                  + min(depth + 1, n_layer) * per_slice)
    else:
        window = int(gathered_bytes)
        notes.append("model not stacked: no layer window to offload")

    window_peak = window + grads_shard + shard
    if optimizer_tier == "hbm":
        window_peak += opt_shard

    return StepPeaks(plain_peak_bytes=int(plain_peak),
                     window_peak_bytes=int(window_peak),
                     shard_bytes=shard,
                     grads_shard_bytes=grads_shard,
                     opt_shard_bytes=opt_shard,
                     has_window=has_window,
                     notes=tuple(notes))


def analytic_step_peaks(num_params: int,
                        world: int,
                        compute_itemsize: int = COMPUTE_ITEMSIZE,
                        block_params: int = 0,
                        n_layer: int = 0,
                        prefetch_depth: int = 2,
                        opt_slots: int = DEFAULT_OPT_SLOTS,
                        optimizer_tier: str = "hbm") -> StepPeaks:
    """:func:`step_peaks` from parameter COUNTS instead of tree bytes —
    the autotuner's pre-run pruner has no live pytree, only
    ``model_info`` dims, but must predict the exact peaks the offload
    planner will enforce at trial init."""
    p = int(num_params)
    blk = min(int(block_params), p)
    return step_peaks(
        param_bytes=MASTER_ITEMSIZE * p,
        gathered_bytes=compute_itemsize * p,
        world=world,
        opt_bytes=None,
        opt_slots=opt_slots,
        block_gathered_bytes=compute_itemsize * blk,
        rest_gathered_bytes=compute_itemsize * (p - blk),
        n_layer=n_layer,
        prefetch_depth=prefetch_depth,
        optimizer_tier=optimizer_tier)


def host_state_bytes(num_params: int, world: int, offload_param: bool,
                     offload_optimizer: bool, opt_slots: int = DEFAULT_OPT_SLOTS) -> int:
    """Host bytes a rank's offload holds: its fp32 master shard with
    ``offload_param`` (stage 3) and its ``opt_slots`` fp32 moment shards
    with ``offload_optimizer``."""
    shard = MASTER_ITEMSIZE * int(num_params) / max(1, int(world))
    return int(shard * (int(bool(offload_param)) + opt_slots * int(bool(offload_optimizer))))
