"""The training engine, ZeRO stages 0-3 with data parallelism and CPU
offload (counterpart of the ``DeepSpeedEngine`` of
``deepspeed_tpu/runtime/engine.py``).

The step is the JAX engine's fused program (one XLA program per optimizer
step over GAS micro-batches, ``deepspeed_tpu/runtime/engine.py:2610-2612``),
in PyTorch:

* fp32 master parameters live in the model (``GPT.set_params``), from
  ``model.init_params(generator)`` seeded with ``seed``, or from
  ``model_parameters`` (a tree or a state dict such as
  ``models/convert.py:params_from_jax`` returns);
* each micro-step casts them to the compute dtype inside the loss, runs the
  forward (per-block remat when the model asks for it) and the backward;
  fp32 gradients accumulate, summed over the GAS micro-steps, in one flat
  buffer whose views are the parameters' ``.grad`` (stable pointers);
* the update unscales by ``1 / (scale * gas)``, takes the global norm
  ``sqrt(sum g^2)`` of the unscaled gradients, folds the clip factor
  ``min(1, clip / (norm + 1e-6))`` and runs one fused AdamW launch over
  every parameter (``runtime/optimizers.py``).

The engine's generator (``engine.rng``, a ``torch.Generator`` on the
device seeded with ``seed``) reaches the model in training: an MoE model
draws its gating noise from it (RTS priorities for top-1, gumbel draws for
top-2), as the JAX engine hands its model a key.  The captured step
registers it, so each replay draws fresh noise; a checkpoint does not hold
its state (the JAX checkpoint holds no key).

No step reads a device value on the host: the returned loss is a device
tensor, and the clip factor, the bias corrections and the learning rate
reach the kernel as device scalars.  So on a CUDA device ``train_batch``
runs the whole step as one replay of a captured CUDA graph, one capture
per batch signature (``runtime/step_graph.py``); ``forward`` /
``backward`` / ``step`` stay eager, as the JAX engine's micro-step path is
separate from its fused program.  On the CPU ``train_batch`` runs the
same step body (``_graph_step``) as it is.
The device and its ``synchronize`` come from ``accelerator/``; entry
points run on the current CUDA device unless ``device="cpu"``.

``save_checkpoint`` / ``load_checkpoint`` are ``runtime/checkpointing.py``
(the JAX layout: verified atomic tags, ``latest``, rollback, retention,
async save).  A load copies into the engine's own storage (parameters,
moments, the optimizer count, the scaler) and never rebinds it, so the
captured steps keep running on the restored state.

Data parallelism and ZeRO (``runtime/zero/``, ``comm/``): one process a
device, ``WORLD_SIZE`` of them, each with its ``micro`` rows of the global
batch (``train_batch_size = micro * gas * world``).  The gradients are
averaged over the ranks, as JAX's mean over the data axis gives:
``inv`` carries ``1 / world`` as it carries ``1 / gas``, and the returned
loss is the mean over the ranks.

* stage 0: one bucketed all-reduce of the flat gradient (none at world
  size 1, where no process group is made: the step is the one above);
* stages 1-2: the model's leaves are views of one full fp32 buffer.  The
  gradients are reduce-scattered into each rank's fp32 gradient shard, at
  the boundary (stage 1) or after every micro-step (stage 2, so between
  micro-steps they live only in the shard); each rank updates its
  partitions, which are all-gathered back into the leaves;
* stage 3: the model holds no weights; the fp32 master is partitioned, and
  each block's leaves are gathered inside its checkpoint by
  ``runtime/zero/partition_parameters.py``, whose backward reduce-scatters
  their gradients into the shard.  ``offload_param: {device: cpu}`` keeps
  the master in host memory (below stage 3 it changes nothing, as in JAX);
* ``offload_optimizer: {device: cpu}`` (stage >= 1) keeps the moments in
  host memory, streamed through the card in pieces (``ZeroAdam``);
* the global norm is one all-reduce of the shards' squared sums (fp64 on
  the CPU, as the stage-0 norm there).

Any stage >= 1 makes a process group, a world of one when there is no
``RANK`` / ``WORLD_SIZE``, and runs its collectives even there.  The fused
AdamW kernel is the update on every path.

The ``telemetry`` block (``telemetry/``) is built in the JAX engine's
order (``deepspeed_tpu/runtime/engine.py:256-370``): the hub, the profiler
window, the registry and the collective monitor into ``comm/``, the tracer
(made global), the watchdog, the flight recorder, the heartbeat gauge, the
health checks and ``/debug/dump``.  Each step buffers one record
(``record_step``: loss, lr, grad norm, loss scale, samples) as device
tensors, drained once a flush window, and drives ``maybe_snapshot``, the
profiler window, the watchdog and the goodput ledger.  All of it runs on
the host around the step: nothing of it is inside ``_graph_step``, whose
host code runs only at the capture, so the captured graph, its launches
and its capture count are the same with telemetry on.  The graphed step's
loss and grad norm are static outputs that the next replay overwrites, so
a record holds a copy of each, made on the engine's stream after the
replay.  ``train_batch`` is one ``train_batch`` span a step (the JAX
engine's name) around the replay; the eager API's are JAX's ``fwd``,
``bwd`` and ``step``.

The robustness plane (the JAX engine's, ``deepspeed_tpu/runtime/engine.py:
2243-2248, 2438-2620, 2865-3235``):

* ``stability`` (``runtime/stability.py``): the sentinel's detectors run
  inside ``_graph_step`` on the all-reduced loss and the global norm, and
  their cause code sets the fused AdamW kernel's skip flag, so an anomalous
  update is suppressed on the device and ``train_batch`` stays one replay a
  step.  The step's stats are copied after each replay, without a wait,
  into pinned memory behind an event; the next boundary reads them (the
  lagged read) and runs the ladder: LR backoff (a device scale the captured
  step multiplies the step size by), rollback into the same graphs, and
  quarantine of the episode's batches, which ``train_batch`` then skips by
  fingerprint before they reach the device.  With a fault plan at the
  value sites ``train.loss`` / ``train.grads`` the update reads their
  device seam (``testing/fault_injection.py``), eager and captured alike;
* ``fault_tolerance.preemption_enabled`` (``runtime/fault_tolerance.py``):
  SIGTERM or a probe sets a flag that the step boundary answers, after the
  replay, with a final synchronous checkpoint ``preempt_step<N>`` and exit
  143;
* ``elasticity.recovery_enabled`` (``comm/recovery.py``): the step runs
  under a deadline (``comm/bounded.py``), and an expired one (a wedged
  collective, which in a graphed step fires at the capture) opens an
  incident and runs the ladder: retry in place, a shrink of the process
  group onto the survivors with the ZeRO partitions laid out again from
  the verified checkpoint, or exit 113 for the elastic agent to restart.

The ``autotuning`` block (``autotuning/``): a tuned patch that the config
applies (``patch`` / ``results_dir``) has its environment fingerprint
checked once the parameters are in and before any step is built
(``stale_policy`` ``warn`` / ``refuse`` / ``off``); under the autotuner
(``DS_AUTOTUNING_METRIC_PATH`` set) each ``steps_per_print`` boundary of
``train_batch`` and of the eager ``step`` writes the throughput the
launcher's autotuner ranks on.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: the NVMe tier, ZeRO++ (quantized weights and gradients, hpZ) and
tensor, pipeline and sequence parallelism (Queue 1 items 7 and 9), fp16
(item 5), ``wall_clock_breakdown`` and the monitor, PLD, compression and
data-pipeline blocks (items 8 and 9).  A
``sparse_attention`` block is accepted (the config checks it), as in the
JAX engine: the model takes its layout through a registered
``attn_impl``.
"""

import dataclasses
import logging
import os
import time
from contextlib import nullcontext
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.models.gpt import GPTConfig
from deepspeed_tpu_torch.ops.cuda.flash_attention import check_head_dim
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import checkpoint_policy
from deepspeed_tpu_torch.runtime.config import UNPORTED_BLOCKS, DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import unit_loss_scaler
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.optimizers import ZeroAdam, adam_spec, get_optimizer
from deepspeed_tpu_torch.runtime.stability import (StabilitySentinel, assign_sentinel_state_,
                                                   fingerprint_batch, init_sentinel_state,
                                                   reset_sentinel_state_, sentinel_observe)
from deepspeed_tpu_torch.runtime.step_graph import StepGraphs
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (FlatStore,
                                                                   PartitionedParameters,
                                                                   init_ctx_active, named_tree)
from deepspeed_tpu_torch.runtime.zero.policy import ZeroLayout, zero_min_size
from deepspeed_tpu_torch.testing import fault_injection
from deepspeed_tpu_torch.testing.fault_injection import fault_point
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

NVME = "ROADMAP.md, Queue 1 item 7 (the NVMe tier)"
ZERO_PP = "ROADMAP.md, Queue 1 item 7 (ZeRO++)"
TENSOR_PARALLEL = "ROADMAP.md, Queue 1 item 7 (tensor parallelism)"
MODEL_PARALLEL = "ROADMAP.md, Queue 1 item 9 (pipeline and sequence parallelism)"
# the largest piece of host state streamed through the card at once: 512 MiB
# of fp32, so three device buffers (master, mu, nu) take 1.5 GiB
OFFLOAD_PIECE_MAX = 2 ** 27
PRECISION = "ROADMAP.md, Queue 1 item 5 (fp16 loss scaling)"
# the fwd / bwd / step timers have no boundary inside one graph replay
WALL_CLOCK = "ROADMAP.md, Queue 1 item 8 (wall_clock_breakdown)"
COMPRESSION = "ROADMAP.md, Queue 1 item 9 (compression)"


def _map_tree(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _tier(block) -> str:
    """An offload block's device as a plain string (none / cpu / nvme)."""
    if block is None:
        return "none"
    return str(getattr(block.device, "value", block.device))


def offload_piece(sub_group_size: int) -> int:
    """Elements of host state the optimizer streams at once: the largest
    power of two within ``sub_group_size`` (the reference's optimizer
    sub-group), at most ``OFFLOAD_PIECE_MAX``."""
    n = max(1, min(int(sub_group_size), OFFLOAD_PIECE_MAX))
    return 1 << (n.bit_length() - 1)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


class _LaggedStat:
    """One of a step's stats in its pinned slot: ``float()`` waits for the
    copy's event (by the next boundary long recorded) and reads it."""

    __slots__ = ("host", "event", "index")

    def __init__(self, host: torch.Tensor, event, index: int):
        self.host, self.event, self.index = host, event, index

    def __float__(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host[self.index])


class DeepSpeedEngine:
    """JSON-configured training engine.  ``model`` follows the port's GPT
    protocol: ``init_params(generator)``, ``set_params(tree,
    requires_grad)``, ``param_tree()`` and ``model(params, batch, rng,
    train) -> loss``."""

    def __init__(self, model=None, config=None, model_parameters=None,
                 lr_scheduler=None, device=None, seed: int = 42):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        self._config = DeepSpeedConfig(config if config is not None else {},
                                       world_size=comm.env_world_size())
        self._reject_unported()
        self.device = resolve_device(device)
        self.accelerator = get_accelerator(self.device.type)
        self.module = model
        self.compute_dtype = self._config.precision_dtype
        zc = self._config.zero_config
        # inside zero.Init the parameters are partitioned as at stage 3
        self._zero_stage = 3 if init_ctx_active() else int(zc.stage)
        if self._config.world_size > 1 or self._zero_stage > 0:
            comm.init_distributed(device=self.device)
        self.world_size, self.rank = comm.get_world_size(), comm.get_rank()
        self._offload_param = _tier(zc.offload_param) == "cpu" and self._zero_stage >= 3
        self._offload_optimizer = _tier(zc.offload_optimizer) == "cpu" and self._zero_stage >= 1
        self._piece = offload_piece(zc.sub_group_size)
        for key, on, least in (("offload_param", self._offload_param, 3),
                               ("offload_optimizer", self._offload_optimizer, 1)):
            if _tier(getattr(zc, key)) == "cpu" and not on:
                log_dist(f"{key} takes effect from ZeRO stage {least}: ignored at stage "
                         f"{self._zero_stage}", ranks=[0], level=logging.WARNING)
        self.zero = None

        # activation checkpointing: the block selects the remat policy and
        # turns on the model's per-block remat, as the JAX engine does
        ac = self._config.activation_checkpointing_config
        checkpoint_policy(ac.partition_activations, ac.cpu_checkpointing)
        mcfg = getattr(model, "cfg", None)
        if isinstance(mcfg, GPTConfig) and self.device.type == "cuda":
            # training needs flash's dQ and dKV at the model's head_dim
            check_head_dim("initialize()", mcfg.head_dim, backward=True)
        if ((ac.contiguous_memory_optimization or ac.number_checkpoints)
                and mcfg is not None and not mcfg.remat):
            model.cfg = dataclasses.replace(mcfg, remat=True)

        self._init_parameters(model, model_parameters, seed)
        self._check_tuned_patch()
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(int(seed))
        self.lr_scheduler = None
        self._schedule_fn = None
        self._configure_lr_scheduler(lr_scheduler)
        self._configure_optimizer()
        self.scaler = unit_loss_scaler(self.device)

        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self._grads_pending = False
        self._grad_norm = None
        self._cached_loss = None        # the last eager forward's loss (telemetry)
        self._in_training_mode = True
        self.checkpoint_engine = None
        self._closed = False
        self._ckpt_finalizer = None
        self._ckpt_finalizer_error = None
        self._last_ckpt_dir = None
        self.graphs = self._make_graphs()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            synchronize=lambda: self.accelerator.synchronize(self.device.index),
            steps_per_output=self._config.steps_per_print or 50)
        # installed before the watchdog (in the telemetry block), so the
        # watchdog's SIGTERM chain ends at this cooperative flag
        self._init_preemption(self._config.fault_tolerance_config)
        self._init_telemetry(self._config.telemetry_config)
        if self.preemption_handler is not None:
            self.preemption_handler.telemetry = self.telemetry
        self._init_stability(self._config.stability_config)
        self._configure_recovery()
        log_dist(f"DeepSpeedEngine ready: device={self.device}, "
                 f"zero_stage={self._zero_stage}, world_size={self.world_size}, "
                 f"offload_param={self._offload_param}, "
                 f"offload_optimizer={self._offload_optimizer}, dtype={self.compute_dtype}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Setup
    # ------------------------------------------------------------------ #
    def _make_graphs(self):
        """The captured steps (CUDA only); a process group captures in the
        thread-local error mode."""
        if self.device.type != "cuda":
            return None
        return StepGraphs(self.accelerator, self.device, self._static_dtype,
                          generators=[self.rng], thread_local=comm.is_initialized())

    def _reject_unported(self):
        cfg = self._config
        zc = cfg.zero_config
        for key in ("offload_param", "offload_optimizer"):
            if _tier(getattr(zc, key)) == "nvme":
                raise NotImplementedError(f"{key} to nvme is not ported yet ({NVME})")
        if (zc.zero_quantized_weights or zc.zero_quantized_gradients
                or zc.zero_hpz_partition_size > 1):
            raise NotImplementedError(f"ZeRO++ (zero_quantized_weights, "
                                      f"zero_quantized_gradients, zero_hpz_partition_size) "
                                      f"is not ported yet ({ZERO_PP})")
        blocks = cfg.parallel_blocks
        mesh = blocks[C.MESH]
        if max(int(blocks[C.TENSOR_PARALLEL].get("tp_size", 1)), int(mesh.get("tensor", 1))) > 1:
            raise NotImplementedError(f"tensor parallelism is not ported yet ({TENSOR_PARALLEL})")
        if max(int(blocks[C.PIPELINE_PARALLEL].get("stages", 1)), int(mesh.get("pipe", 1)),
               int(blocks[C.SEQUENCE_PARALLEL].get("sp_size", 1)), int(mesh.get("seq", 1))) > 1:
            raise NotImplementedError(f"pipeline and sequence parallelism are not ported yet "
                                      f"({MODEL_PARALLEL})")
        if cfg.fp16_config.enabled or cfg.amp_enabled:
            raise NotImplementedError(f"fp16 / amp training is not ported yet ({PRECISION})")
        for key, item in UNPORTED_BLOCKS.items():
            if cfg.unported_blocks[key].get("enabled", False):
                raise NotImplementedError(f"the {key!r} block is not ported yet ({item})")
        if cfg.compression_config:
            raise NotImplementedError(f"compression_training is not ported yet ({COMPRESSION})")
        if cfg.wall_clock_breakdown:
            raise NotImplementedError(f"wall_clock_breakdown is not ported yet ({WALL_CLOCK})")

    def _init_telemetry(self, tcfg):
        """The ``telemetry`` block's planes, in the JAX engine's order; all
        None when it is off, and then no step takes a telemetry branch."""
        self.telemetry = None
        self.profiler_window = None
        self.tracer = None
        self.watchdog = None
        self.flight_recorder = None
        if not tcfg.enabled:
            return
        from deepspeed_tpu_torch.comm import comm as comm_backend
        from deepspeed_tpu_torch.telemetry import (FlightRecorder, HangWatchdog, ProfilerWindow,
                                                   TelemetryHub, Tracer, set_global_tracer,
                                                   watchdog_health_check)
        self.telemetry = TelemetryHub.from_config(
            tcfg, batch_size=self.train_batch_size(),
            steps_per_print=self._config.steps_per_print, device=self.device)
        self.profiler_window = ProfilerWindow.from_config(tcfg)
        if self.telemetry.registry is not None:
            # live per-op wire-byte counters off comm/
            comm_backend.configure_metrics_registry(self.telemetry.registry)
        mon = self.telemetry.collective_monitor
        if mon is not None:
            comm_backend.configure_collective_monitor(mon)
        if tcfg.tracing or tcfg.watchdog_enabled:
            # the tracer is global so that comm/ and checkpointing annotate
            # spans without an engine; every span pets the watchdog
            if tcfg.watchdog_enabled:
                self.watchdog = HangWatchdog(timeout_s=tcfg.watchdog_timeout_s,
                                             poll_s=tcfg.watchdog_poll_s)
            self.tracer = Tracer(rank=self.rank, capacity=tcfg.trace_buffer_size,
                                 heartbeat=self.watchdog.pet if self.watchdog else None)
            set_global_tracer(self.tracer)
            if self.watchdog is not None:
                self.flight_recorder = FlightRecorder(
                    tcfg.flight_recorder_dir, rank=self.rank, hub=self.telemetry,
                    tracer=self.tracer, collective_monitor=mon)
                self.watchdog.on_stall = self.flight_recorder.on_stall
                if mon is not None:
                    # the stall log names the collective the run is stuck in
                    self.watchdog.context_fn = mon.wedged_summary
                if tcfg.watchdog_signal_dump:
                    self.watchdog.install_signal_handlers()
                self.watchdog.start()
        # what only the engine owns on the live plane: the heartbeat gauge,
        # the watchdog health check and the recorder behind /debug/dump
        if self.telemetry.registry is not None:
            if self.watchdog is not None:
                self.telemetry.registry.gauge("watchdog_heartbeat_age_s",
                                              fn=self.watchdog.heartbeat_age_s)
            srv = self.telemetry.obs_server
            if srv is not None:
                if self.watchdog is not None:
                    srv.add_health_check("watchdog", watchdog_health_check(self.watchdog))
                if self.flight_recorder is not None:
                    srv.flight_recorder = self.flight_recorder

    def _span(self, name, **args):
        """A tracer span, or an inert context when tracing is off."""
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, **args)

    def _init_parameters(self, model, model_parameters, seed: int):
        """fp32 master parameters on the device, made the model's own."""
        if model_parameters is None:
            if not hasattr(model, "init_params"):
                raise ValueError("Pass model_parameters (a parameter tree or state dict) or "
                                 "use a model with .init_params(generator)")
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            tree = _map_tree(lambda t: t.to(self.device, torch.float32),
                             model.init_params(gen))
        else:
            tree = _map_tree(lambda t: torch.as_tensor(np.asarray(t) if not isinstance(
                t, torch.Tensor) else t).to(self.device, torch.float32, copy=True),
                model_parameters)
        model.set_params(tree, requires_grad=True)
        self.params = model.param_tree()
        self._names, leaves = map(list, zip(*model.named_parameters()))
        if [id(p) for p in leaves] != [id(p) for p in _leaves(self.params)]:
            raise ValueError("the model's named_parameters() and param_tree() disagree")
        sizes = [p.numel() for p in leaves]
        self._shapes = [tuple(p.shape) for p in leaves]
        self._num_params = sum(sizes)
        if self._zero_stage == 0:
            # one flat fp32 gradient buffer; its views are the .grad tensors,
            # so autograd accumulates in place and the optimizer's pointers hold
            self._grad_flat = torch.zeros(sum(sizes), dtype=torch.float32, device=self.device)
            self._grads = list(torch.split(self._grad_flat, sizes))
            for p, g in zip(leaves, self._grads):
                p.grad = g.view_as(p)
            self._leaves = leaves
        else:
            layout = ZeroLayout(self._names, sizes, self.world_size, self.rank,
                                zero_min_size(self._config.zero_config))
            self.zero = PartitionedParameters(self._names, leaves, self._zero_stage, layout,
                                              self.device, self.compute_dtype,
                                              offload_param=self._offload_param,
                                              piece=self._piece)
            del tree, leaves
            if self._zero_stage >= 3:
                self._grad_flat = None
                self._place_stage3_placeholders()
            else:
                self._grad_flat = self.zero.grad_flat
                model.set_params(named_tree(dict(zip(self._names, self.zero.model_leaves()))),
                                 requires_grad=True)
                own = dict(model.named_parameters())
                for name, g in zip(self._names, self.zero.grad_views()):
                    own[name].grad = g
            self.params = model.param_tree()
            log_dist(layout.describe(), ranks=[0])
        log_dist(f"model parameters: {self._num_params:,}", ranks=[0])

    def _check_tuned_patch(self) -> None:
        """When the ds_config applies an emitted autotuner patch
        (``autotuning.patch`` / ``results_dir``), check the patch's
        environment fingerprint against this run: the mesh the JAX engine
        would build for it, the parameter count (known once the parameters
        are in) and the torch version; ``stale_policy`` ``warn`` (default)
        logs each mismatch, ``refuse`` raises ``StaleTuningError`` before
        any step is built, ``off`` skips it
        (``deepspeed_tpu/runtime/engine.py:490-499``)."""
        at_cfg = self._config.autotuning_config or {}
        if not (at_cfg.get("patch") or at_cfg.get("results_dir")):
            return
        from deepspeed_tpu_torch.autotuning import fingerprint
        fingerprint.check_engine(
            at_cfg, mesh_shape=fingerprint.data_parallel_mesh(self.world_size, self._zero_stage),
            num_params=self._num_params, device=self.device)

    def _place_stage3_placeholders(self) -> None:
        """Stage 3: the model holds empty leaves (its weights are the
        partitions); ``GatheredParameters`` puts whole ones in for a while."""
        self.module.set_params(named_tree({n: torch.empty(0, device=self.device)
                                           for n in self._names}))

    def _configure_lr_scheduler(self, client_lr_scheduler):
        if self._config.scheduler_name is not None:
            self.lr_scheduler = get_lr_schedule(self._config.scheduler_name,
                                                self._config.scheduler_params)
            self._schedule_fn = self.lr_scheduler.schedule_fn()
        elif client_lr_scheduler is not None:
            self.lr_scheduler = client_lr_scheduler
            if hasattr(client_lr_scheduler, "schedule_fn"):
                self._schedule_fn = client_lr_scheduler.schedule_fn()

    def _configure_optimizer(self):
        name = self._config.optimizer_name or "adam"
        if self.zero is None:
            self.optimizer = get_optimizer(name, dict(self._config.optimizer_params),
                                           self._leaves, [p.grad for p in self._leaves],
                                           lr_schedule=self._schedule_fn, names=self._names)
            return
        spec = adam_spec(name, dict(self._config.optimizer_params), self._schedule_fn)
        z = self.zero
        n = z.layout.shard_numel
        mu, nu = (FlatStore(n, self.device, host=self._offload_optimizer, piece=self._piece)
                  for _ in range(2))
        self.optimizer = ZeroAdam(spec, z.master_segments(), z.grad_shard, mu, nu,
                                  master_store=z.master, gather_full=z.full_named,
                                  scatter=z.shard_copies)
        self._check_hbm_budget()

    def _check_hbm_budget(self):
        """The residency planner's gate (``runtime/offload/``): with a budget
        (``hbm_budget_bytes`` or ``DST_HBM_BUDGET_BYTES``), refuse a step
        whose plain stage-3 peak, and with offload its layer-window peak,
        does not fit it (``HBMBudgetError``), as the JAX engine does."""
        from deepspeed_tpu_torch.runtime import offload
        zc = self._config.zero_config
        budget = (int(os.environ.get("DST_HBM_BUDGET_BYTES", "0") or 0)
                  or int(zc.hbm_budget_bytes or 0))
        if budget <= 0:
            return
        shapes = named_tree({n: torch.empty(s, device="meta")
                             for n, s in zip(self._names, self._shapes)})
        p_dev, o_dev = _tier(zc.offload_param), _tier(zc.offload_optimizer)
        plan = offload.plan_residency(
            shapes, None, budget_bytes=budget, world=self.world_size,
            compute_itemsize=torch.empty((), dtype=self.compute_dtype).element_size(),
            prefetch_depth=int(zc.prefetch_depth),
            params_tier="hbm" if p_dev == "none" else p_dev,
            optimizer_tier="hbm" if o_dev == "none" else o_dev)
        self._residency_plan = plan
        offload.check_budget(plan, offload_enabled=(p_dev != "none"))
        log_dist(plan.describe(), ranks=[0])

    # ------------------------------------------------------------------ #
    # Training API
    # ------------------------------------------------------------------ #
    def train(self, mode: bool = True):
        self._in_training_mode = mode
        return self

    def eval(self):
        return self.train(False)

    def _static_dtype(self, dtype: torch.dtype) -> torch.dtype:
        return self.compute_dtype if dtype.is_floating_point else dtype

    @staticmethod
    def _as_tensor(x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))

    def _place(self, x):
        if isinstance(x, (tuple, list)):
            return type(x)(self._place(v) for v in x)
        t = self._as_tensor(x)
        return t.to(self.device, self._static_dtype(t.dtype))

    def _loss(self, batch, train: bool = True) -> torch.Tensor:
        if self._zero_stage >= 3:
            tree = self.zero.compute_tree()      # gathered in the compute dtype
        else:
            tree = _map_tree(lambda p: p.to(self.compute_dtype), self.params)
        return self.module(tree, batch, self.rng if train else None, train).float()

    def forward(self, *inputs):
        """The loss of one micro-batch; in train mode the autograd graph is
        kept for ``backward``.  With the stability block a quarantined
        micro-batch is skipped (the loss is 0 and ``backward`` a no-op), as
        in the JAX engine."""
        raw = inputs if len(inputs) != 1 else inputs[0]
        if self.stability is not None and self._in_training_mode:
            fp = fingerprint_batch(raw)
            self._last_fp = fp or ""
            if self._skip_quarantined(fp, self.micro_steps):
                self._skip_micro = True
                self._cached_loss = None
                return torch.zeros((), dtype=torch.float32, device=self.device)
            if fp is not None:
                self._step_fps.append(fp)
        batch = self._place(raw)
        if self._in_training_mode:
            if not self._grads_pending and not self.tput_timer.started:
                self.tput_timer.start()      # the step's first micro-batch
            if self.profiler_window is not None:
                self.profiler_window.step_begin(self.global_steps)
            if self.watchdog is not None:
                self.watchdog.arm(f"fwd step={self.global_steps}")
        with self._span("fwd", step=self.global_steps, micro_step=self.micro_steps):
            if self._in_training_mode:
                loss = self._loss(batch)
                self._cached_loss = loss.detach()
            else:
                with torch.no_grad():
                    loss = self._loss(batch, train=False)
        return loss

    __call__ = forward

    def backward(self, loss: torch.Tensor):
        """Accumulate the micro-batch gradients into the flat buffer."""
        if not self._in_training_mode:
            raise RuntimeError("backward called in eval mode")
        if self._skip_micro:
            # a quarantined forward: nothing to accumulate, but the micro
            # counter moves past the batch
            self._skip_micro = False
            self.micro_steps += 1
            return loss
        with self._span("bwd", micro_step=self.micro_steps):
            if not self._grads_pending:
                self._zero_grads()
                self._grads_pending = True
            elif self._zero_stage == 2:
                self._grad_flat.zero_()
            (loss.float() * self.scaler.scale).backward()
            self.micro_steps += 1
            self._reduce_gradients(self.is_gradient_accumulation_boundary())
        return loss

    def _zero_grads(self) -> None:
        if self._grad_flat is not None:
            self._grad_flat.zero_()
        if self.zero is not None:
            self.zero.grad_shard.zero_()

    def _own_grads(self) -> torch.Tensor:
        """The gradients the update reads: the flat buffer at stage 0, the
        rank's shard at stages 1-3."""
        return self._grad_flat if self.zero is None else self.zero.grad_shard

    def _reduce_gradients(self, boundary: bool) -> None:
        """After a micro-step's backward: stage 2 reduce-scatters its
        gradients into the shard, stage 1 the step's at the boundary, stage
        0 all-reduces them at the boundary (world size > 1); stage 3's
        backward has reduce-scattered them already."""
        if self._zero_stage == 0:
            if boundary and self.world_size > 1:
                bucket = max(1, int(self._config.zero_config.reduce_bucket_size))
                for start in range(0, self._grad_flat.numel(), bucket):
                    comm.all_reduce(self._grad_flat[start:start + bucket])
        elif self._zero_stage == 2 or (self._zero_stage == 1 and boundary):
            self.zero.reduce_grads()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Optimizer step at GAS boundaries.  The value sites
        ``train.loss`` (the last micro-batch's loss, none when it was
        quarantined) and ``train.grads`` are hit here, as in the JAX
        engine's micro-step path."""
        if self.is_gradient_accumulation_boundary() and self._grads_pending:
            with self._span("step", step=self.global_steps):
                loss = self._cached_loss
                self._arm_seam(loss_hit=loss is not None)
                if self.stability is not None and loss is not None and self.world_size > 1:
                    loss = comm.all_reduce(loss.clone()) / self.world_size
                self._grad_norm, stats, loss = self._apply_updates(loss)
                self._grads_pending = False
                self._advance_step_counters(loss, self._grad_norm,
                                            stats=self._stash_stats(stats))
            self.tput_timer.stop(global_step=True)
            self._report_progress()
            if self.watchdog is not None:
                # between optimizer steps the host legitimately blocks in
                # user code (data loading): not a stall
                self.watchdog.disarm()

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over GAS micro-batches.  ``batch`` leaves have
        a leading ``[gas, micro, ...]`` dimension, or ``data_iter`` yields
        the GAS micro-batches.  Returns the mean micro-batch loss as a
        device tensor.  The step is ``_graph_step``, starting from zeroed
        gradients: on CUDA one replay of its captured graph, on the CPU the
        same body run as it is.

        With collective recovery on this is also the recovery boundary, as
        in the JAX engine: the step runs under the collective deadline, and
        an expired deadline (or a peer's abort, or a dead rank seen at the
        boundary) opens an incident and runs the ladder.  The retry runs
        the same batch: a step that an abandoned call already ran is not
        run again.  After a shrink the step counter went back to the
        checkpoint, so a batch from ``data_iter`` is drawn again."""
        if not self._in_training_mode:
            raise RuntimeError("train_batch called in eval mode")
        if self.recovery_manager is None:
            return self._train_batch_inner(data_iter, batch)
        from deepspeed_tpu_torch.comm.bounded import CollectiveTimeout
        gas = self.gradient_accumulation_steps()
        from_iter = batch is None
        micro = [next(data_iter) for _ in range(gas)] if from_iter else None
        while True:
            self._recovery_boundary()
            if self._recovery_pending_rung == "shrink" and from_iter:
                micro = [next(data_iter) for _ in range(self.gradient_accumulation_steps())]
            try:
                loss = self._train_batch_inner(None, batch, micro=micro)
            except CollectiveTimeout as err:
                self._handle_collective_timeout(err)
                continue
            except RuntimeError as err:
                # a peer that died mid-collective (gloo: "connection closed
                # by peer"; NCCL: the communicator failed); any other error
                # is raised again
                self._handle_collective_failure(err)
                continue
            if self._recovery_pending_rung is not None:
                self.recovery_manager.note_recovered(self._recovery_pending_rung,
                                                     detail={"step": self.global_steps})
                self._recovery_pending_rung = None
                self._recovery_attempt = 0
            return loss

    def _train_batch_inner(self, data_iter=None, batch=None, micro=None):
        gas = self.gradient_accumulation_steps()
        if batch is None:
            micro = micro if micro is not None else [next(data_iter) for _ in range(gas)]
            sources = [[self._as_tensor(mb[j]) for mb in micro] for j in range(len(micro[0]))]
        else:
            sources = [self._as_tensor(x) for x in batch]
        key = ()
        self._seam_on = False
        if self.stability is not None:
            kept = self._unquarantined(sources)
            if not kept:
                # every micro-batch is quarantined: no step, as in JAX
                self.micro_steps += gas
                return torch.zeros((), dtype=torch.float32, device=self.device)
            if len(kept) < gas:
                # the quarantined micro-batches are dropped on the host; at
                # ZeRO 2-3, whose collectives run per micro-batch, ranks must
                # drop the same positions, as they do on the replay after a
                # rollback (every rank quarantined its batches of the episode)
                sources = [src[kept] if isinstance(src, torch.Tensor)
                           else [src[i] for i in kept] for src in sources]
            self._last_kept = kept[-1] == gas - 1
            # the value sites are hit on this path only, as the JAX engine
            # routes its stability block to the micro-step path; the seam
            # is part of the capture
            self._arm_seam(loss_hit=self._last_kept)
            key = (("last_kept", self._last_kept), ("seam", self._seam_on))
        if self.profiler_window is not None:
            self.profiler_window.step_begin(self.global_steps)
        if self.watchdog is not None:
            self.watchdog.arm(f"train_batch step={self.global_steps}")
        self.tput_timer.start()
        with self._span("train_batch", step=self.global_steps, gas=gas):
            if self.graphs is None:
                out = self._run_bounded(
                    lambda: self._graph_step([self._place(x) for x in sources]))
                loss, self._grad_norm = out[0], out[1]
                grad_norm = self._grad_norm
            else:
                # a stability step's capture is keyed by what it captured
                extra = {"key": key} if key else {}
                out = self._run_bounded(lambda: self.graphs.run(sources, self._graph_step,
                                                                **extra))
                self._grad_norm = out[1]
                loss = out[0].clone()          # the next replay overwrites the static output
                # ... and the norm's: a record buffered until the flush
                # holds this step's own copy
                grad_norm = self._grad_norm.clone() if self.telemetry is not None else None
            recorded, stats = loss, None
            if self.stability is not None:
                stats = self._stash_stats(out[2])
                # the JAX engine's micro-step path records the loss its
                # sentinel judged (after the value site), none when the last
                # micro-batch was quarantined
                recorded = (out[2][1].clone() if self.telemetry is not None and self._last_kept
                            else None)
            self.micro_steps += gas
            self._grads_pending = False
            self._advance_step_counters(recorded, grad_norm, stats=stats)
        if self.watchdog is not None:
            self.watchdog.disarm()
        self.tput_timer.stop(global_step=True)
        self._report_progress()
        return loss

    def _report_progress(self) -> None:
        """Autotuning experiment mode: at each ``steps_per_print`` boundary
        write ``{"throughput", "global_steps"}`` to
        ``$DS_AUTOTUNING_METRIC_PATH``, the metric the launcher's autotuner
        ranks on (``deepspeed_tpu/runtime/engine.py:3294-3309``; no
        ``FLOPS_per_gpu``: the flops profiler is not ported).  It runs on the
        host after the step (after the replay of a graphed one); reading the
        throughput drains the device once a window."""
        from deepspeed_tpu_torch.autotuning.scheduler import METRIC_PATH_ENV, write_metrics
        spp = self._config.steps_per_print
        metric_path = os.environ.get(METRIC_PATH_ENV)
        if not (metric_path and spp and self.global_steps % spp == 0):
            return
        metrics = {"throughput": self.tput_timer.avg_samples_per_sec(),
                   "global_steps": self.global_steps}
        try:
            write_metrics(metric_path, metrics)
        except OSError as e:
            logger.warning(f"autotuning metric write failed: {e}")

    def _graph_step(self, leaves):
        """The step that ``train_batch`` runs, and on CUDA captures: zero
        the flat gradients, the forward and backward micro-steps over
        ``[n, ...]`` leaves (or lists of n micro-batch tensors), the
        update.  Touches no host counter.  Returns (mean loss, grad norm),
        and with the stability block the step's stats (cause code, the
        sentinel's loss, grad norm, loss scale).

        The leaves hold the GAS micro-batches, or with the stability block
        those that are not quarantined (``train_batch`` dropped the others
        on the host); the mean divides by GAS all the same, as the JAX
        engine counts a quarantined micro-batch as a loss of 0.  The
        sentinel judges the last micro-batch's loss, the rank mean, or 0
        when that micro-batch was quarantined (``_last_kept``, part of the
        capture's key), as the JAX engine's micro-step path does."""
        self._zero_grads()
        gas = self.gradient_accumulation_steps()
        n = len(leaves[0])
        loss_sum = last = None
        for i in range(n):
            if i and self._zero_stage == 2:
                self._grad_flat.zero_()
            loss = self._loss(tuple(x[i] for x in leaves))
            (loss * self.scaler.scale).backward()
            self._reduce_gradients(i == n - 1)
            loss = last = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        loss = loss_sum / gas
        if self.world_size > 1:
            loss = comm.all_reduce(loss) / self.world_size
        judged = None
        if self.stability is not None and self._last_kept:
            judged = loss
            if gas > 1:
                judged = (comm.all_reduce(last.clone()) / self.world_size
                          if self.world_size > 1 else last)
        grad_norm, stats, _ = self._apply_updates(judged)
        if stats is None:
            return loss, grad_norm
        return loss, grad_norm, stats

    def _apply_updates(self, loss: Optional[torch.Tensor] = None):
        """The value sites' seam when armed (``loss`` and the gradients
        times ``mult`` plus ``add``, from the static device scalars that
        ``_arm_seam`` filled), unscale (``1 / (scale * gas * world)``), global norm, clip factor,
        the fused AdamW update (one launch, or one a chunk of offloaded
        state), and at stages 1-2 the all-gather of the updated partitions;
        returns (the global norm, the stability stats or None, ``loss``
        after the seam).  ``inv`` is
        computed on the device from the scaler's scale tensor, which a
        captured step reads at every replay: bf16 and fp32 hold it at 1;
        fp16 (ROADMAP.md, Queue 1 item 5) must update that tensor in place.

        With the stability block the sentinel observes ``loss`` (0 when
        None, as in JAX) and the norm on the device (``runtime/stability.py``), its cause
        code sets the kernel's skip flag (``skip_anomalous_steps``) and
        ``skipped`` counts it; the LR backoff's device scale multiplies
        the step size."""
        if self._seam_on:
            seam = self._seam
            if loss is not None:
                loss = loss * seam[0] + seam[1]
            with torch.no_grad():
                self._own_grads().mul_(seam[2]).add_(seam[3])
        inv = 1.0 / (self.scaler.scale
                     * float(self.gradient_accumulation_steps() * self.world_size))
        if self.zero is not None:
            grad_norm = self.zero.sq_norm().sqrt().float() * inv
        elif self._grad_flat.is_cuda:
            grad_norm = torch.linalg.vector_norm(self._grad_flat) * inv
        else:
            # the CPU reduction sums fp32 squares in sequence, which over a
            # few million values drifts by ~1e-4 from the tree sum of XLA
            # (and of the card); fp64 keeps it to fp32 rounding
            grad_norm = torch.linalg.vector_norm(self._grad_flat, dtype=torch.float64).float() * inv
        clip = self.gradient_clipping()
        if clip and clip > 0:
            factor = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
        else:
            factor = torch.ones_like(grad_norm)
        skip = lr_scale = stats = None
        if self.stability is not None:
            scfg = self._stability_cfg
            loss_in = (loss.float() if loss is not None
                       else torch.zeros((), dtype=torch.float32, device=self.device))
            new_state, code = sentinel_observe(
                self.sentinel, loss_in, grad_norm, self._no_flag, self._no_flag,
                warmup_steps=scfg.warmup_steps, ema_alpha=scfg.ema_alpha,
                grad_spike_factor=scfg.grad_spike_factor,
                loss_spike_zscore=scfg.loss_spike_zscore,
                scale_collapse_windows=scfg.scale_collapse_windows)
            assign_sentinel_state_(self.sentinel, new_state)
            if scfg.skip_anomalous_steps:
                with torch.no_grad():
                    self._skip.copy_((code > 0).to(torch.float32))
                    self.skipped.add_((code > 0).to(torch.int32))
            skip, lr_scale = self._skip, self._lr_scale_dev
            stats = torch.stack([code.to(torch.float32), loss_in, grad_norm.float(),
                                 self.scaler.scale.float().reshape(())])
        self.optimizer.step(inv, factor, skip=skip, lr_scale=lr_scale)
        if self.zero is not None and self._zero_stage < 3:
            self.zero.gather_params()
        return grad_norm, stats, loss

    def _advance_step_counters(self, loss: Optional[torch.Tensor] = None,
                               grad_norm: Optional[torch.Tensor] = None, stats=None):
        """Host counters after a step, then the step's telemetry (the
        JAX engine's ``_advance_step_counters``): the record of ``loss``
        and ``grad_norm`` (device tensors, read at the flush), the
        cross-rank snapshot, the profiler window and the goodput ledger;
        then the boundary: the ``train.step`` fault site, the stability
        ladder on ``stats`` and the preemption flag, in JAX's order."""
        self.global_samples += self.train_batch_size()
        self.global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.telemetry is not None:
            self.telemetry.record_step(
                self.global_steps, loss=loss, lr=self.get_lr()[0], grad_norm=grad_norm,
                loss_scale=self.scaler.scale.clone(), global_samples=self.global_samples)
            self.telemetry.maybe_snapshot(self.global_steps)
            if self.telemetry.ledger is not None:
                gas = max(1, self.gradient_accumulation_steps())
                self.telemetry.ledger.on_step(self.global_steps,
                                              quarantine_frac=self._skipped_micros_step / gas)
        self._skipped_micros_step = 0
        if self.profiler_window is not None:
            self.profiler_window.step_end(self.global_steps)
        # on the host after the step (a graphed step's replay included),
        # never inside a capture
        fault_point("train.step", step=self.global_steps)
        if self.stability is not None:
            self._stability_boundary(stats)
        if self.preemption_handler is not None and self.preemption_handler.triggered:
            self._preemption_exit()

    # ------------------------------------------------------------------ #
    # Training-stability sentinel (runtime/stability.py)
    # ------------------------------------------------------------------ #
    def _init_stability(self, scfg) -> None:
        """The sentinel's host ladder and its device state; all None when
        the block is off, and then no step takes a stability branch and the
        captured step is the one without it."""
        self._stability_cfg = scfg
        self.stability = None
        self._lr_backoff_scale = 1.0
        self._step_fps = []            # fingerprints of the open step
        self._last_fp = ""             # fingerprint of the latest micro-batch
        self._skip_micro = False       # a quarantined forward: backward is a no-op
        self._skipped_micros_step = 0  # quarantined micro-batches of the open step
        self._last_kept = True         # the step's last micro-batch is not quarantined
        self._seam_on = False
        self._seam = torch.tensor([1.0, -0.0, 1.0, -0.0], dtype=torch.float32,
                                  device=self.device)
        if not scfg.enabled:
            return
        self.stability = StabilitySentinel(scfg, telemetry=self.telemetry, read_fn=float)
        dev = self.device
        self.sentinel = init_sentinel_state(dev)
        self._no_flag = torch.zeros((), dtype=torch.bool, device=dev)  # overflow, min scale
        self._skip = torch.zeros((), dtype=torch.float32, device=dev)
        self._lr_scale_dev = torch.ones((), dtype=torch.float32, device=dev)
        self.skipped = torch.zeros((), dtype=torch.int32, device=dev)
        pin = dev.type == "cuda"
        # two slots: the boundary reads step N-1's while step N's copy is
        # in flight
        self._stats_host = [torch.zeros(4, dtype=torch.float32, pin_memory=pin)
                            for _ in range(2)]
        self._stats_events = ([torch.cuda.Event() for _ in range(2)] if pin else [None, None])
        self._stats_slot = 0

    @property
    def skipped_steps(self) -> int:
        """Steps whose update the sentinel suppressed (reads the device)."""
        return int(self.skipped) if self.stability is not None else 0

    def _skip_quarantined(self, fp: Optional[str], micro_step: int) -> bool:
        """True (with JAX's ``batch_quarantined`` record and the ledger's
        skip) when ``fp`` is quarantined."""
        if fp is None or not self.stability.is_quarantined(fp):
            return False
        if self.telemetry is not None:
            self.telemetry.emit("batch_quarantined",
                                {"fp": fp, "phase": "skipped", "step": self.global_steps,
                                 "micro_step": micro_step}, step=self.global_steps)
            if self.telemetry.ledger is not None:
                self.telemetry.ledger.note_quarantine_skip()
        logger.warning(f"[stability] skipping quarantined batch {fp} at micro step {micro_step}")
        self._skipped_micros_step += 1
        return True

    def _unquarantined(self, sources):
        """The indices of a ``train_batch``'s micro-batches that are not
        quarantined, fingerprinted on the host before they are placed on
        the device (the JAX engine fingerprints each ``forward``'s batch)."""
        kept, fps = [], []
        for i in range(self.gradient_accumulation_steps()):
            fp = fingerprint_batch(tuple(src[i] for src in sources))
            self._last_fp = fp or ""
            if not self._skip_quarantined(fp, self.micro_steps + i):
                kept.append(i)
                if fp is not None:
                    fps.append(fp)
        self._step_fps = fps
        return kept

    def _arm_seam(self, loss_hit: bool) -> None:
        """Whether this step applies the value sites' seam (a plan names a
        value site), and if so this step's hits as ``(mult, add)`` pairs in
        the static device scalars that ``_apply_updates`` reads.  The loss
        site is hit only when the step has a loss to judge, as in JAX."""
        self._seam_on = fault_injection.value_sites_armed()
        if not self._seam_on:
            return
        ctx = dict(step=self.global_steps, fp=self._last_fp)
        clean = (1.0, -0.0)
        vals = ((fault_injection.numeric_seam("train.loss", **ctx) if loss_hit else clean)
                + fault_injection.numeric_seam("train.grads", **ctx))
        self._seam.copy_(torch.tensor(vals, dtype=torch.float32))

    def _stash_stats(self, stats: Optional[torch.Tensor]):
        """Copy a step's stats, without a wait, into the next pinned slot
        behind an event; the boundary of the next step reads them."""
        if stats is None:
            return None
        slot, self._stats_slot = self._stats_slot, self._stats_slot ^ 1
        host, event = self._stats_host[slot], self._stats_events[slot]
        host.copy_(stats.detach(), non_blocking=True)
        if event is not None:
            event.record()
        return {key: _LaggedStat(host, event, i)
                for i, key in enumerate(("anomaly_code", "loss", "grad_norm", "loss_scale"))}

    def _stability_boundary(self, stats) -> None:
        """The sentinel's boundary half: buffer this step's stats, judge
        the previous step's (the lagged read), and run the ladder's
        action."""
        fps, self._step_fps = self._step_fps, []
        action = self.stability.observe(self.global_steps, stats or {}, fingerprints=fps)
        if action is None or action["action"] == "skip":
            # the skip itself already happened on the device
            return
        with self._span("stability", action=action["action"], cause=action.get("cause"),
                        step=action.get("step")):
            if action["action"] == "lr_backoff":
                self._stability_lr_backoff(action)
            elif action["action"] == "rollback":
                self._stability_rollback(action)

    def _set_lr_backoff(self, scale: float) -> None:
        """The backoff's cumulative scale, on the host (``get_lr``) and in
        the device scalar the captured step multiplies the step size by."""
        self._lr_backoff_scale = float(scale)
        self._lr_scale_dev.fill_(self._lr_backoff_scale)

    def _stability_lr_backoff(self, action) -> None:
        factor = self._stability_cfg.lr_backoff_factor
        self._set_lr_backoff(self._lr_backoff_scale * factor)
        scale = self._lr_backoff_scale
        self.stability.note_lr_backoff()
        lr = self.get_lr()[0]
        logger.warning(f"[stability] LR backoff x{factor} after {action['consecutive']} "
                       f"consecutive anomalies (cumulative scale {scale}, lr {lr})")
        if self.telemetry is not None:
            self.telemetry.emit("lr_backoff",
                                {"step": action["step"], "cause": action["cause"],
                                 "factor": factor, "lr_scale": scale, "lr": lr,
                                 "count": self.stability.lr_backoffs},
                                step=self.global_steps)

    def _stability_rollback(self, action) -> None:
        """Load the last verified checkpoint in place (the captured steps
        run on, with no new capture), quarantine the episode's batches."""
        cfg = self._stability_cfg
        load_dir = cfg.rollback_load_dir or self._last_ckpt_dir
        if not load_dir:
            logger.error("[stability] rollback requested but no checkpoint directory is known "
                         "(no save_checkpoint yet and stability.rollback_load_dir unset); the "
                         "ladder stays at skip")
            self.stability.reset_episode()
            return
        from_step = self.global_steps
        # before the load: the load restores the saved sentinel state
        candidates = self.stability.episode_fingerprints()
        path, _client = self.load_checkpoint(load_dir)
        if path is None:
            logger.error(f"[stability] auto-rollback found no loadable verified checkpoint "
                         f"under {load_dir}")
            self.stability.reset_episode()
            return
        added = self.stability.after_rollback(candidates, step=self.global_steps)
        tag = os.path.basename(str(path).rstrip("/"))
        logger.warning(f"[stability] auto-rollback: step {from_step} -> {self.global_steps} "
                       f"(tag {tag}), quarantined {len(added)} batch fingerprint(s)")
        if self.telemetry is not None:
            for fp in added:
                self.telemetry.emit("batch_quarantined",
                                    {"fp": fp, "phase": "quarantined", "step": self.global_steps},
                                    step=self.global_steps)
            self.telemetry.emit("auto_rollback",
                                {"from_step": from_step, "to_step": self.global_steps,
                                 "dir": load_dir, "tag": tag, "cause": action["cause"],
                                 "quarantined": len(added),
                                 "count": self.stability.auto_rollbacks},
                                step=self.global_steps)
            if self.telemetry.ledger is not None:
                self.telemetry.ledger.on_rollback(from_step, self.global_steps)
            self.telemetry.flush()
        self._cached_loss = None
        self._skip_micro = False
        self._step_fps = []

    def _stability_state_for_checkpoint(self) -> Optional[Dict]:
        """The ladder's state for the checkpoint's ``client_state.json``
        (``"stability"``, the JAX layout), or None without the block."""
        if self.stability is None:
            return None
        sd = self.stability.state_dict()
        sd["lr_backoff_scale"] = self._lr_backoff_scale
        return sd

    def _after_checkpoint_load(self, meta) -> None:
        """After a load: the ladder's state from the checkpoint, its LR
        scale into the device scalar, and the sentinel's device state
        zeroed in place (its EMAs described a trajectory that is gone)."""
        if self.stability is None:
            return
        sd = (meta or {}).get("stability") or {}
        self.stability.load_state_dict(sd)
        self._set_lr_backoff(float(sd.get("lr_backoff_scale", 1.0)))
        reset_sentinel_state_(self.sentinel)
        self._step_fps = []
        self._skip_micro = False

    # ------------------------------------------------------------------ #
    # Preemption (runtime/fault_tolerance.py)
    # ------------------------------------------------------------------ #
    def _init_preemption(self, ftcfg) -> None:
        self.preemption_handler = None
        if not ftcfg.preemption_enabled:
            return
        from deepspeed_tpu_torch.runtime.fault_tolerance import PreemptionHandler, resolve_probe
        self.preemption_handler = PreemptionHandler(
            probe=resolve_probe(ftcfg.preemption_probe), poll_s=ftcfg.preemption_poll_s)
        self.preemption_handler.install().start()

    def _preemption_exit(self):
        """Answer a preemption notice: one final *synchronous* checkpoint
        ``preempt_step<N>`` into the configured directory (else where the
        last checkpoint went), joined under ``preemption_grace_s`` and booked
        as ``ckpt_stall``, the ``preemption`` record, then exit
        :data:`PREEMPTION_EXIT_CODE` so the elastic agent restarts without
        spending its restart budget."""
        from deepspeed_tpu_torch.runtime.checkpointing import wait_for_finalizer
        from deepspeed_tpu_torch.runtime.fault_tolerance import PREEMPTION_EXIT_CODE
        ftcfg = self._config.fault_tolerance_config
        reason = self.preemption_handler.reason if self.preemption_handler else "unknown"
        save_dir = ftcfg.preemption_save_dir or self._last_ckpt_dir
        saved_tag = None
        if save_dir:
            try:
                tag = f"preempt_step{self.global_steps}"
                self.save_checkpoint(save_dir, tag=tag)
                # the grace window is all there is: block until durable
                t0 = time.monotonic()
                wait_for_finalizer(self, timeout=ftcfg.preemption_grace_s)
                if self.telemetry is not None and self.telemetry.ledger is not None:
                    self.telemetry.ledger.note_ckpt_stall(time.monotonic() - t0)
                saved_tag = tag
            except Exception as e:
                logger.error(f"preemption checkpoint failed: {e}")
        else:
            logger.warning("preemption: no save dir known (never saved and no "
                           "preemption_save_dir configured); exiting without a final "
                           "checkpoint")
        if self.telemetry is not None:
            try:
                self.telemetry.emit("preemption",
                                    {"phase": "exit", "reason": reason,
                                     "step": self.global_steps, "dir": str(save_dir or ""),
                                     "tag": saved_tag, "saved": saved_tag is not None},
                                    step=self.global_steps)
                self.telemetry.flush()
            except Exception as e:
                logger.warning(f"preemption telemetry failed: {e}")
        self.close()
        raise SystemExit(PREEMPTION_EXIT_CODE)

    # ------------------------------------------------------------------ #
    # Coordinated collective recovery (comm/bounded.py + comm/recovery.py)
    # ------------------------------------------------------------------ #
    def _configure_recovery(self) -> None:
        """The recovery plane from the ``elasticity`` block's recovery keys,
        as the JAX engine builds it: the step under the collective deadline
        (``BoundedCollective`` on a worker thread, on this device and
        stream), a ``RecoveryCoordinator`` over the file rendezvous when
        one is configured, and the ``RecoveryManager`` ladder behind
        ``/recovery``, the ``recovery`` health check and the ledger's
        ``comm_recovery``.  Everything stays None when recovery is off."""
        from deepspeed_tpu_torch.comm.recovery import (FileRendezvous, RecoveryCoordinator,
                                                       RecoveryManager, RecoveryPolicy,
                                                       resolve_rank_world)
        self.recovery_policy = RecoveryPolicy.from_config(self._config)
        self.recovery_coordinator = None
        self.recovery_manager = None
        self._bounded = None
        self._recovery_attempt = 0
        self._recovery_pending_rung = None
        self._last_liveness_poll = 0.0
        self._ran_step = None
        if not self.recovery_policy.enabled:
            return
        pol = self.recovery_policy
        if pol.rendezvous_dir:
            rank, world = resolve_rank_world(default_world=self.world_size)
            rdv = FileRendezvous(pol.rendezvous_dir, rank=rank, world_size=world)
            self.recovery_coordinator = RecoveryCoordinator(rdv, pol).start()
        ledger = self.telemetry.ledger if self.telemetry is not None else None
        self.recovery_manager = RecoveryManager(pol, coordinator=self.recovery_coordinator,
                                                telemetry=self.telemetry, ledger=ledger)
        from deepspeed_tpu_torch.comm.bounded import BoundedCollective
        cuda = self.device.type == "cuda"
        self._bounded = BoundedCollective(
            deadline_s=pol.collective_timeout_s, on_timeout=self._on_step_timeout,
            device=self.device if cuda else None,
            stream=torch.cuda.current_stream(self.device) if cuda else None)
        if self.telemetry is not None and self.telemetry.obs_server is not None:
            srv = self.telemetry.obs_server
            srv.recovery_fn = self.recovery_manager.status
            srv.add_health_check("recovery", self.recovery_manager.health_check)
        log_dist(f"collective recovery enabled: deadline={pol.collective_timeout_s}s, "
                 f"rendezvous={pol.rendezvous_dir or 'none (single-process ladder)'}",
                 ranks=[0])

    def _run_bounded(self, thunk):
        """The step under the collective deadline (the call itself when
        recovery is off).  A step that an abandoned call finished is not
        run again: its outputs are taken (``_on_step_timeout``)."""
        if self._bounded is None:
            return thunk()
        if self._ran_step is not None:
            out, self._ran_step = self._ran_step, None
            return out
        return self._bounded.run(thunk, op=f"train_step:{self.global_steps}")

    def _on_step_timeout(self, err) -> None:
        """The deadline expired: mark the call abandoned, free a planted
        wedge, and wait for the call to end, so that nothing runs on the
        device behind the ladder's back.  A call in a capture ends it (the
        stream leaves capture mode) and drops the half-built graph; one
        that finished its step leaves the step's outputs (eager: kept here;
        graphed: the graphs' pending warm-up).  Wedges are armed again for
        a later rule."""
        if self.graphs is not None:
            self.graphs.abandon()
        fault_injection.release_wedges()
        job = getattr(err, "job", None)
        wait = max(self.recovery_policy.collective_timeout_s, 1.0)
        if job is not None and job.done.wait(wait) and job.error is None:
            self._ran_step = job.result
        if job is not None:
            job.error = None          # its traceback's frames hold what the call made
        if self.graphs is not None and not self.graphs.wait_idle(wait):
            raise RuntimeError("an abandoned step did not end its capture within "
                               f"{wait:.0f} s")
        fault_injection.arm_wedges()

    def _recovery_boundary(self) -> None:
        """Step-boundary recovery checks (the JAX engine's): feed the
        coordinator the step counter, join an abort a peer signalled, and
        look for dead ranks (a same-host pid probe)."""
        coord = self.recovery_coordinator
        if coord is None:
            return
        coord.note_step(self.global_steps)
        doc = coord.poll_abort()
        if doc is not None:
            self.recovery_manager.begin_incident(doc.get("cause", "peer_abort"),
                                                 detail=doc.get("detail"),
                                                 step=self.global_steps)
            self._run_recovery_ladder()
            return
        now = time.monotonic()
        if now - self._last_liveness_poll < self.recovery_policy.heartbeat_interval_s:
            return
        self._last_liveness_poll = now
        dead = coord.dead_ranks()
        if dead:
            detail = {"dead_ranks": dead}
            self.recovery_manager.begin_incident("rank_dead", detail=detail,
                                                 step=self.global_steps)
            coord.request_abort("rank_dead", detail)
            self._run_recovery_ladder()

    def _handle_collective_timeout(self, err) -> None:
        """A bounded step expired on this rank: open the incident, signal
        the coordinated abort (the first writer wins), run the ladder."""
        detail = {"error": str(err), "op": getattr(err, "op", None)}
        logger.error(f"collective deadline expired: {detail}")
        self.recovery_manager.begin_incident("collective_timeout", detail=detail,
                                             step=self.global_steps,
                                             backdate_s=getattr(err, "deadline_s", 0.0) or 0.0)
        if self.recovery_coordinator is not None:
            self.recovery_coordinator.request_abort("collective_timeout", detail)
        self._run_recovery_ladder()

    def _handle_collective_failure(self, err) -> None:
        """A step raised: a collective that failed outright because a peer
        died (the liveness probe confirms it within ``heartbeat_timeout_s``)
        or a ``torch.distributed`` error opens the incident of a dead rank or
        of a failed collective; any other error is raised again."""
        coord = self.recovery_coordinator
        dead = []
        if coord is not None:
            deadline = time.monotonic() + self.recovery_policy.heartbeat_timeout_s
            while not dead and time.monotonic() < deadline:
                dead = coord.dead_ranks()
                if not dead:
                    time.sleep(self.recovery_policy.heartbeat_interval_s)
        if not dead and not isinstance(err, torch.distributed.DistError):
            raise err
        cause = "rank_dead" if dead else "collective_error"
        detail = {"error": str(err)[:500], "dead_ranks": dead}
        logger.error(f"collective failed: {detail}")
        self.recovery_manager.begin_incident(cause, detail=detail, step=self.global_steps)
        if coord is not None:
            coord.request_abort(cause, detail)
        self._run_recovery_ladder()

    def _run_recovery_ladder(self) -> None:
        """One ladder iteration for an open incident (the JAX engine's).

        With a coordinator: ack and barrier, so every survivor leaves the
        step at this boundary, then the rung from the survivor set (the
        leader publishes the plan, the others wait for it).  Without one the
        ladder is retry, then restart.  ``retry`` returns to the caller's
        loop; ``shrink`` makes the process group again over the kept ranks
        and exits an excluded live rank with :data:`MESH_SHRINK_EXIT_CODE`;
        ``restart`` exits with :data:`RECOVERY_RESTART_EXIT_CODE`."""
        mgr, pol, coord = self.recovery_manager, self.recovery_policy, self.recovery_coordinator
        if coord is not None:
            survivors = coord.abort_barrier()
            world = coord.world_size
        else:
            survivors, world = [0], 1
        attempt = self._recovery_attempt
        rung = pol.next_rung(attempt, len(survivors), world)
        mgr.note_rung(rung, attempt=attempt,
                      detail={"survivors": survivors, "world_size": world})
        if rung == "retry":
            self._recovery_attempt += 1
            self._recovery_pending_rung = "retry"
            self._cached_loss = None
            if coord is not None:
                coord.advance_epoch()
            time.sleep(pol.retry_delay_s(attempt))
            mgr.book_rung_complete()
            return
        if rung == "shrink":
            plan = None
            if coord is not None and coord.is_leader(survivors):
                target = pol.shrink_target(len(survivors))
                kept = list(range(target))
                dead = sorted(set(range(world)) - set(survivors))
                if any(r not in survivors for r in kept):
                    # a kept slot's rank is dead: the survivors cannot keep
                    # their rank ids in the smaller group
                    plan = coord.publish_plan({"rung": "restart", "cause": "shrink_infeasible",
                                               "dead_ranks": dead})
                else:
                    plan = coord.publish_plan({"rung": "shrink", "new_world": target,
                                               "kept_ranks": kept, "dead_ranks": dead,
                                               "load_dir": self._last_ckpt_dir})
            elif coord is not None:
                plan = coord.await_plan()
            if plan is None:
                mgr.note_failed("no_plan", detail={"survivors": survivors})
                raise RuntimeError("recovery ladder: no shrink plan materialized within the "
                                   "deadline")
            if plan.get("rung") == "restart":
                self._recovery_restart_exit(plan)
            mgr.note_quarantined(plan.get("dead_ranks", []), detail={"epoch": plan.get("epoch")})
            my_rank = coord.rank if coord is not None else 0
            if my_rank not in plan.get("kept_ranks", []):
                self._mesh_shrink_exit(plan)
            self._execute_mesh_shrink(plan)
            self._recovery_pending_rung = "shrink"
            mgr.book_rung_complete()
            return
        if rung == "restart":
            self._recovery_restart_exit(None)
        mgr.note_failed("ladder_exhausted", detail={"survivors": survivors, "world": world})
        raise RuntimeError("collective recovery ladder exhausted "
                           "(retry/shrink/restart all unavailable)")

    def _recovery_exit(self, cause: str, code: int, plan) -> None:
        """Drop the coordinator-confirmed marker the elastic agent reads,
        flush, close and exit with the reserved ``code``."""
        from deepspeed_tpu_torch.comm.recovery import write_recovery_marker
        pol = self.recovery_policy
        if pol.rendezvous_dir:
            try:
                write_recovery_marker(pol.rendezvous_dir, cause,
                                      epoch=(self.recovery_coordinator.epoch
                                             if self.recovery_coordinator is not None else 0),
                                      extra={"plan": plan, "step": self.global_steps})
            except OSError as e:
                logger.warning(f"recovery marker write failed: {e}")
        if self.telemetry is not None:
            try:
                self.telemetry.flush()
            except Exception:
                pass
        self.close()
        raise SystemExit(code)

    def _recovery_restart_exit(self, plan) -> None:
        """The final rung: exit :data:`RECOVERY_RESTART_EXIT_CODE` (113); the
        agent restarts without spending its restart budget."""
        from deepspeed_tpu_torch.comm.recovery import RECOVERY_RESTART_EXIT_CODE
        self._recovery_exit("restart", RECOVERY_RESTART_EXIT_CODE, plan)

    def _mesh_shrink_exit(self, plan) -> None:
        """A live rank the shrink plan leaves out exits
        :data:`MESH_SHRINK_EXIT_CODE` (114)."""
        from deepspeed_tpu_torch.comm.recovery import MESH_SHRINK_EXIT_CODE
        log_dist(f"mesh shrink: rank excluded by plan (new_world={plan.get('new_world')}), "
                 "exiting", ranks=[0])
        self._recovery_exit("mesh_shrink", MESH_SHRINK_EXIT_CODE, plan)

    def _execute_mesh_shrink(self, plan) -> None:
        """Rebuild this engine over the kept ranks and reload the newest
        verified checkpoint: destroy the process group, make it again over
        the survivors on the same store under a prefix of its own for the
        epoch, solve the batch for the new world, lay the ZeRO partitions
        and the optimizer out again (their placeholder values are then
        overwritten by the load), and drop every captured graph: their NCCL
        communicator is gone."""
        import torch.distributed as dist
        new_world = int(plan["new_world"])
        epoch = self.recovery_coordinator.epoch if self.recovery_coordinator is not None else 0
        store = dist.distributed_c10d._get_default_store()
        backend = dist.get_backend()
        if self.graphs is not None:
            self.graphs.clear()
        if self.zero is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.zero.close()
            self.optimizer.mu.close()
            self.optimizer.nu.close()
        comm.destroy_process_group()
        kw = {"device_id": self.device} if self.device.type == "cuda" else {}
        dist.init_process_group(backend, store=dist.PrefixStore(f"dst_recovery_{epoch}", store),
                                rank=self.rank, world_size=new_world, **kw)
        os.environ["WORLD_SIZE"] = str(new_world)
        self.world_size, self.rank = comm.get_world_size(), comm.get_rank()
        self._config.resolve_batch_size(new_world)
        self.tput_timer.batch_size = self.train_batch_size()
        self._init_parameters(self.module, None, 0)
        self._configure_optimizer()
        self.graphs = self._make_graphs()
        if self.stability is not None:
            reset_sentinel_state_(self.sentinel)
        self._cached_loss = None
        self._grads_pending = False
        self._ran_step = None
        load_dir = plan.get("load_dir") or self._last_ckpt_dir
        if load_dir:
            path, _ = self.load_checkpoint(load_dir)
            log_dist(f"mesh shrink: world={new_world}, resumed from {path}", ranks=[0])
        else:
            logger.warning("mesh shrink: no checkpoint known; continuing from freshly "
                           "initialized state")
        if self.recovery_coordinator is not None:
            self.recovery_coordinator.advance_epoch(
                new_world_size=len(plan.get("kept_ranks", [])) or new_world)
        self.recovery_manager.note_world_size(new_world)

    # ------------------------------------------------------------------ #
    # Introspection (the JAX engine's property surface)
    # ------------------------------------------------------------------ #
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def zero_optimization_stage(self):
        return self._config.zero_config.stage

    def pinned_bytes(self) -> int:
        """Host bytes this engine's offload holds pinned (master and moments)."""
        n = self.zero.pinned_bytes() if self.zero is not None else 0
        if isinstance(self.optimizer, ZeroAdam):
            n += self.optimizer.mu.pinned_bytes() + self.optimizer.nu.pinned_bytes()
        return n

    def get_lr(self):
        """The learning rate of the next step; with the stability block the
        LR backoff's scale is in it, in fp32, as the JAX engine's scaled
        schedule gives it."""
        if self.stability is not None and self.lr_scheduler is None:
            base = np.float32(self._config.optimizer_params.get("lr", 0.0) or 0.0)
            return [float(base * np.float32(self._lr_backoff_scale))]
        if self._schedule_fn is not None:
            lr = self._schedule_fn(self.global_steps)
            if self.stability is not None:
                lr = torch.as_tensor(lr, dtype=torch.float32) * np.float32(self._lr_backoff_scale)
            return [float(lr)]
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "get_lr"):
            return self.lr_scheduler.get_lr()
        return [float(self._config.optimizer_params.get("lr", 0.0))]

    def get_global_grad_norm(self) -> float:
        """The last step's global norm (reads the device)."""
        return float(self._grad_norm) if self._grad_norm is not None else 0.0

    def loss_scale(self) -> float:
        return float(self.scaler.scale)

    @property
    def config(self):
        return self._config

    # ------------------------------------------------------------------ #
    # Checkpoints (runtime/checkpointing.py)
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True):
        from deepspeed_tpu_torch.runtime.checkpointing import save_checkpoint as _save
        t0 = time.monotonic()
        try:
            return _save(self, save_dir, tag=tag, client_state=client_state or {},
                         save_latest=save_latest)
        finally:
            if self.telemetry is not None and self.telemetry.ledger is not None:
                # the blocking part of the save (an async finalize runs off
                # the step path)
                self.telemetry.ledger.note_ckpt_stall(time.monotonic() - t0)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False):
        """``(tag dir, client_state)``, or ``(None, {})`` when nothing was
        loaded.  Copies into the existing storage: the captured steps run
        on the restored state without a new capture."""
        from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint as _load
        return _load(self, load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
                     load_lr_scheduler_states=load_lr_scheduler_states,
                     load_module_only=load_module_only)

    def _checkpoint_state(self) -> Dict:
        """The tree a checkpoint holds: fp32 master params by name, the
        optimizer's mu, nu and count, and the scaler.  A ZeRO engine
        gathers its partitions into whole leaves (every rank calls this), so
        a checkpoint has one layout at every stage and world size."""
        params = (dict(zip(self._names, self._leaves)) if self.zero is None
                  else self.zero.full_named(None))
        tree = {"params": params, "opt_state": self.optimizer.state_dict(),
                "scaler": self.scaler._asdict()}
        if self.stability is not None:
            tree["skipped"] = self.skipped      # JAX's state holds the count too
        return tree

    def _check_named(self, named: Dict, what: str) -> None:
        """Raise unless ``named`` has this model's leaf names and shapes."""
        if set(named) != set(self._names):
            raise ValueError(f"{what} {sorted(set(named) ^ set(self._names))[:5]} "
                             "do not match the model's")
        for name, shape in zip(self._names, self._shapes):
            got = tuple(torch.as_tensor(named[name]).shape)
            if got != shape:
                raise ValueError(f"{what} {name}: shape {got}, expected {shape}")

    def _param_copies(self, params: Dict) -> list:
        """``(own tensor, value)`` pairs writing whole fp32 leaves by name
        into this engine's parameters (a ZeRO engine's partitions)."""
        self._check_named(params, "checkpoint params")
        if self.zero is not None:
            return self.zero.shard_copies(params, None)
        return [(p, torch.as_tensor(params[n])) for n, p in zip(self._names, self._leaves)]

    def _checkpoint_copies(self, tree: Dict, load_optimizer_states: bool = True):
        """``(own tensor, saved value)`` for every tensor a load writes: the
        params, the optimizer state and the scaler, each name and shape
        checked against this engine before the first copy, so that a tree
        that does not fit raises and changes nothing."""
        copies = self._param_copies(tree["params"])
        if load_optimizer_states:
            if self.zero is not None:
                for key in ("mu", "nu"):
                    self._check_named(tree["opt_state"][key], f"optimizer state {key}")
            copies += self.optimizer.state_copies(tree["opt_state"])
        for field, dst in self.scaler._asdict().items():
            src = torch.as_tensor(tree["scaler"][field])
            if src.numel() != dst.numel():
                raise ValueError(f"checkpoint scaler {field}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            copies.append((dst, src.reshape(dst.shape)))
        if self.stability is not None and "skipped" in tree:
            copies.append((self.skipped, torch.as_tensor(tree["skipped"]).reshape(())))
        return copies

    @staticmethod
    @torch.no_grad()
    def _copy_in(copies) -> None:
        """Write what ``_checkpoint_copies`` checked into the engine's own
        storage, in place: a captured step keeps its pointers."""
        for dst, src in copies:
            dst.copy_(src)

    def get_fp32_params(self) -> Dict[str, torch.Tensor]:
        """The fp32 master parameters by name, as host copies (a ZeRO engine
        gathers them: every rank calls this)."""
        if self.zero is not None:
            return self.zero.full_named(None)
        return {n: p.detach().to("cpu", copy=True) for n, p in zip(self._names, self._leaves)}

    def save_16bit_model(self, save_dir, save_filename="model.safetensors"):
        """An ``.npz`` of fp16 leaves ``p0``, ``p1``, ... in parameter
        order, as the JAX engine writes it; returns its path."""
        params = self.get_fp32_params()
        path = os.path.join(save_dir, "model_16bit.npz")
        if self.rank == 0:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(path, **{f"p{i}": t.to(torch.float16).numpy()
                              for i, t in enumerate(params.values())})
        return path

    def telemetry_flush(self):
        """Drain buffered telemetry records to all sinks now (one device
        sync).  No-op when telemetry is off."""
        if self.telemetry is not None:
            self.telemetry.flush()

    def telemetry_close(self):
        """End-of-run hook: stop an in-flight profiler capture, flush and
        close every sink (``EFFICIENCY.json`` included), detach the registry
        and the monitor from ``comm/``, stop the watchdog and export this
        rank's span timeline.  Idempotent."""
        if self.profiler_window is not None:
            self.profiler_window.close()
        if self.telemetry is not None:
            from deepspeed_tpu_torch.comm import comm as comm_backend
            self.telemetry.close()
            if (self.telemetry.registry is not None
                    and comm_backend._METRICS_REGISTRY is self.telemetry.registry):
                comm_backend.configure_metrics_registry(None)
            if (self.telemetry.collective_monitor is not None
                    and comm_backend._COLLECTIVE_MONITOR is self.telemetry.collective_monitor):
                comm_backend.configure_collective_monitor(None)
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.tracer is not None:
            from deepspeed_tpu_torch.telemetry.tracing import (export_rank_trace,
                                                               get_global_tracer,
                                                               set_global_tracer)
            export_rank_trace(self.tracer, self._config.telemetry_config.trace_dir)
            if get_global_tracer() is self.tracer:
                set_global_tracer(None)
            self.tracer.close()

    def close(self):
        """Join the async checkpoint finalizer (logging, not raising, its
        failure), drain the checkpoint engine, close the telemetry, and
        drop the captured steps with their memory pools.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        from deepspeed_tpu_torch.runtime.checkpointing import wait_for_finalizer
        try:
            wait_for_finalizer(self, raise_on_error=False)
        except Exception as e:
            log_dist(f"checkpoint finalizer join failed: {e}", ranks=[0])
        if self.checkpoint_engine is not None:
            try:
                self.checkpoint_engine.wait()
            except Exception as e:
                log_dist(f"checkpoint engine drain failed: {e}", ranks=[0])
        for name, what in (("preemption_handler", "stop"), ("recovery_coordinator", "stop"),
                           ("_bounded", "shutdown")):
            obj = getattr(self, name, None)
            if obj is not None:
                try:
                    getattr(obj, what)()
                except Exception as e:
                    logger.warning(f"{name} {what} failed: {e}")
        try:
            self.telemetry_close()
        except Exception as e:
            logger.warning(f"telemetry close failed: {e}")
        if self.graphs is not None:
            if self._grad_norm is not None:
                self._grad_norm = self._grad_norm.clone()
            self.graphs.clear()
        if self.zero is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.zero.close()
            self.optimizer.mu.close()
            self.optimizer.nu.close()
