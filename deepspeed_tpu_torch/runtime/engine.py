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

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: the NVMe tier, ZeRO++ (quantized weights and gradients, hpZ) and
tensor, pipeline and sequence parallelism (Queue 1 items 7 and 9), fp16
(item 5), preemption handling, ``wall_clock_breakdown`` and the stability,
monitor, PLD, compression and data-pipeline blocks (items 8 and 9).  A
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
from deepspeed_tpu_torch.runtime.step_graph import StepGraphs
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (FlatStore,
                                                                   PartitionedParameters,
                                                                   init_ctx_active, named_tree)
from deepspeed_tpu_torch.runtime.zero.policy import ZeroLayout, zero_min_size
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
        self.graphs = (StepGraphs(self.accelerator, self.device, self._static_dtype,
                                  generators=[self.rng],
                                  thread_local=comm.is_initialized())
                       if self.device.type == "cuda" else None)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            synchronize=lambda: self.accelerator.synchronize(self.device.index),
            steps_per_output=self._config.steps_per_print or 50)
        self._init_telemetry(self._config.telemetry_config)
        log_dist(f"DeepSpeedEngine ready: device={self.device}, "
                 f"zero_stage={self._zero_stage}, world_size={self.world_size}, "
                 f"offload_param={self._offload_param}, "
                 f"offload_optimizer={self._offload_optimizer}, dtype={self.compute_dtype}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Setup
    # ------------------------------------------------------------------ #
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
        flags = {"fault_tolerance": "preemption_enabled"}
        for key, item in UNPORTED_BLOCKS.items():
            if cfg.unported_blocks[key].get(flags.get(key, "enabled"), False):
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
        kept for ``backward``."""
        batch = self._place(inputs if len(inputs) != 1 else inputs[0])
        if self._in_training_mode:
            if self.profiler_window is not None:
                self.profiler_window.step_begin(self.global_steps)
            if self.watchdog is not None:
                self.watchdog.arm(f"fwd step={self.global_steps}")
        with self._span("fwd", step=self.global_steps, micro_step=self.micro_steps):
            if self._in_training_mode:
                loss = self._loss(batch)
                if self.telemetry is not None:
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
        """Optimizer step at GAS boundaries."""
        if self.is_gradient_accumulation_boundary() and self._grads_pending:
            with self._span("step", step=self.global_steps):
                self._grad_norm = self._apply_updates()
                self._grads_pending = False
                self._advance_step_counters(self._cached_loss, self._grad_norm)
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
        same body run as it is."""
        if not self._in_training_mode:
            raise RuntimeError("train_batch called in eval mode")
        gas = self.gradient_accumulation_steps()
        if batch is None:
            micro = [next(data_iter) for _ in range(gas)]
            sources = [[self._as_tensor(mb[j]) for mb in micro] for j in range(len(micro[0]))]
        else:
            sources = [self._as_tensor(x) for x in batch]
        if self.profiler_window is not None:
            self.profiler_window.step_begin(self.global_steps)
        if self.watchdog is not None:
            self.watchdog.arm(f"train_batch step={self.global_steps}")
        self.tput_timer.start()
        with self._span("train_batch", step=self.global_steps, gas=gas):
            if self.graphs is None:
                loss, self._grad_norm = self._graph_step([self._place(x) for x in sources])
                grad_norm = self._grad_norm
            else:
                loss, self._grad_norm = self.graphs.run(sources, self._graph_step)
                loss = loss.clone()          # the next replay overwrites the static output
                # ... and the norm's: a record buffered until the flush
                # holds this step's own copy
                grad_norm = self._grad_norm.clone() if self.telemetry is not None else None
            self.micro_steps += gas
            self._grads_pending = False
            self._advance_step_counters(loss, grad_norm)
        if self.watchdog is not None:
            self.watchdog.disarm()
        self.tput_timer.stop(global_step=True)
        return loss

    def _graph_step(self, leaves):
        """The step that ``train_batch`` runs, and on CUDA captures: zero
        the flat gradients, the GAS forward and backward micro-steps over
        ``[gas, ...]`` leaves (or lists of GAS micro-batch tensors), the
        update.  Touches no host counter.  Returns (mean loss, grad norm)."""
        self._zero_grads()
        gas = self.gradient_accumulation_steps()
        loss_sum = None
        for i in range(gas):
            if i and self._zero_stage == 2:
                self._grad_flat.zero_()
            loss = self._loss(tuple(x[i] for x in leaves))
            (loss * self.scaler.scale).backward()
            self._reduce_gradients(i == gas - 1)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        loss = loss_sum / gas
        if self.world_size > 1:
            loss = comm.all_reduce(loss) / self.world_size
        return loss, self._apply_updates()

    def _apply_updates(self) -> torch.Tensor:
        """Unscale (``1 / (scale * gas * world)``), global norm, clip factor,
        the fused AdamW update (one launch, or one a chunk of offloaded
        state), and at stages 1-2 the all-gather of the updated partitions;
        returns the global norm.  ``inv`` is computed on the device from the
        scaler's scale tensor, which a captured step reads at every replay:
        bf16 and fp32 hold it at 1; fp16 (ROADMAP.md, Queue 1 item 5) must
        update that tensor in place."""
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
        self.optimizer.step(inv, factor)
        if self.zero is not None and self._zero_stage < 3:
            self.zero.gather_params()
        return grad_norm

    def _advance_step_counters(self, loss: Optional[torch.Tensor] = None,
                               grad_norm: Optional[torch.Tensor] = None):
        """Host counters after a step, then the step's telemetry (the
        JAX engine's ``_advance_step_counters``): the record of ``loss``
        and ``grad_norm`` (device tensors, read at the flush), the
        cross-rank snapshot, the profiler window and the goodput ledger."""
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
                self.telemetry.ledger.on_step(self.global_steps)
        if self.profiler_window is not None:
            self.profiler_window.step_end(self.global_steps)
        # on the host after the step (a graphed step's replay included),
        # never inside a capture
        fault_point("train.step", step=self.global_steps)

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
        if self._schedule_fn is not None:
            return [float(self._schedule_fn(self.global_steps))]
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
        return {"params": params, "opt_state": self.optimizer.state_dict(),
                "scaler": self.scaler._asdict()}

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
