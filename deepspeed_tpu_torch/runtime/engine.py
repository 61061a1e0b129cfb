"""The training engine, single device, ZeRO-0 (counterpart of the
``DeepSpeedEngine`` of ``deepspeed_tpu/runtime/engine.py``).

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

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: ZeRO stages 1-3 and offload (Queue 1 item 7), fp16 (item 5),
preemption handling and the stability, telemetry, monitor, PLD,
compression and data-pipeline blocks (items 8 and 9).  A
``sparse_attention`` block is accepted (the config checks it), as in the
JAX engine: the model takes its layout through a registered
``attn_impl``.
"""

import dataclasses
import os
from typing import Callable, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.models.gpt import GPTConfig
from deepspeed_tpu_torch.ops.cuda.flash_attention import check_head_dim
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import checkpoint_policy
from deepspeed_tpu_torch.runtime.config import UNPORTED_BLOCKS, DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import unit_loss_scaler
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.optimizers import get_optimizer
from deepspeed_tpu_torch.runtime.step_graph import StepGraphs
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

ZERO = "ROADMAP.md, Queue 1 item 7 (ZeRO-1/2/3 and offload)"
PRECISION = "ROADMAP.md, Queue 1 item 5 (fp16 loss scaling)"
OPS_PLANES = "ROADMAP.md, Queue 1 items 8 and 9"
COMPRESSION = "ROADMAP.md, Queue 1 item 9 (compression)"


def _map_tree(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


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
        self._config = DeepSpeedConfig(config if config is not None else {})
        self._reject_unported()
        self.device = resolve_device(device)
        self.accelerator = get_accelerator(self.device.type)
        self.module = model
        self.compute_dtype = self._config.precision_dtype

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
        self._in_training_mode = True
        self.checkpoint_engine = None
        self._closed = False
        self.graphs = (StepGraphs(self.accelerator, self.device, self._static_dtype,
                                  generators=[self.rng])
                       if self.device.type == "cuda" else None)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            synchronize=lambda: self.accelerator.synchronize(self.device.index),
            steps_per_output=self._config.steps_per_print or 50)
        log_dist(f"DeepSpeedEngine ready: device={self.device}, zero_stage=0, "
                 f"dtype={self.compute_dtype}, "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()}, "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Setup
    # ------------------------------------------------------------------ #
    def _reject_unported(self):
        cfg = self._config
        zc = cfg.zero_config
        if zc.stage > 0:
            raise NotImplementedError(f"ZeRO stage {zc.stage} is not ported yet ({ZERO})")
        for block in (zc.offload_param, zc.offload_optimizer):
            if block is not None and str(block.device) not in ("none", "OffloadDeviceEnum.none"):
                raise NotImplementedError(f"ZeRO offload is not ported yet ({ZERO})")
        if cfg.fp16_config.enabled or cfg.amp_enabled:
            raise NotImplementedError(f"fp16 / amp training is not ported yet ({PRECISION})")
        flags = {"fault_tolerance": "preemption_enabled"}
        for key, item in UNPORTED_BLOCKS.items():
            if cfg.unported_blocks[key].get(flags.get(key, "enabled"), False):
                raise NotImplementedError(f"the {key!r} block is not ported yet ({item})")
        if cfg.compression_config:
            raise NotImplementedError(f"compression_training is not ported yet ({COMPRESSION})")
        if cfg.wall_clock_breakdown:
            raise NotImplementedError(f"wall_clock_breakdown is not ported yet ({OPS_PLANES})")

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
        # one flat fp32 gradient buffer; its views are the .grad tensors, so
        # autograd accumulates in place and the optimizer's pointers hold
        sizes = [p.numel() for p in leaves]
        self._grad_flat = torch.zeros(sum(sizes), dtype=torch.float32, device=self.device)
        self._grads = list(torch.split(self._grad_flat, sizes))
        for p, g in zip(leaves, self._grads):
            p.grad = g.view_as(p)
        self._leaves = leaves
        self._num_params = sum(sizes)
        log_dist(f"model parameters: {self._num_params:,}", ranks=[0])

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
        self.optimizer = get_optimizer(name, dict(self._config.optimizer_params),
                                       self._leaves, [p.grad for p in self._leaves],
                                       lr_schedule=self._schedule_fn, names=self._names)

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
        cast = _map_tree(lambda p: p.to(self.compute_dtype), self.params)
        return self.module(cast, batch, self.rng if train else None, train).float()

    def forward(self, *inputs):
        """The loss of one micro-batch; in train mode the autograd graph is
        kept for ``backward``."""
        batch = self._place(inputs if len(inputs) != 1 else inputs[0])
        if self._in_training_mode:
            loss = self._loss(batch)
        else:
            with torch.no_grad():
                loss = self._loss(batch, train=False)
        return loss

    __call__ = forward

    def backward(self, loss: torch.Tensor):
        """Accumulate the micro-batch gradients into the flat buffer."""
        if not self._in_training_mode:
            raise RuntimeError("backward called in eval mode")
        if not self._grads_pending:
            self._grad_flat.zero_()
            self._grads_pending = True
        (loss.float() * self.scaler.scale).backward()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Optimizer step at GAS boundaries."""
        if self.is_gradient_accumulation_boundary() and self._grads_pending:
            self._grad_norm = self._apply_updates()
            self._grads_pending = False
            self._advance_step_counters()

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
        self.tput_timer.start()
        if self.graphs is None:
            loss, self._grad_norm = self._graph_step([self._place(x) for x in sources])
        else:
            loss, self._grad_norm = self.graphs.run(sources, self._graph_step)
            loss = loss.clone()          # the next replay overwrites the static output
        self.micro_steps += gas
        self._grads_pending = False
        self._advance_step_counters()
        self.tput_timer.stop(global_step=True)
        return loss

    def _graph_step(self, leaves):
        """The step that ``train_batch`` runs, and on CUDA captures: zero
        the flat gradients, the GAS forward and backward micro-steps over
        ``[gas, ...]`` leaves (or lists of GAS micro-batch tensors), the
        update.  Touches no host counter.  Returns (mean loss, grad norm)."""
        self._grad_flat.zero_()
        gas = self.gradient_accumulation_steps()
        loss_sum = None
        for i in range(gas):
            loss = self._loss(tuple(x[i] for x in leaves))
            (loss * self.scaler.scale).backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / gas, self._apply_updates()

    def _apply_updates(self) -> torch.Tensor:
        """Unscale, global norm, clip factor, one fused AdamW launch; the
        global norm.  ``inv`` is computed on the device from the scaler's
        scale tensor, which a captured step reads at every replay: bf16 and
        fp32 hold it at 1; fp16 (ROADMAP.md, Queue 1 item 5) must update
        that tensor in place."""
        inv = 1.0 / (self.scaler.scale * float(self.gradient_accumulation_steps()))
        if self._grad_flat.is_cuda:
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
        return grad_norm

    def _advance_step_counters(self):
        self.global_samples += self.train_batch_size()
        self.global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()

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
        return _save(self, save_dir, tag=tag, client_state=client_state or {},
                     save_latest=save_latest)

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
        optimizer's mu, nu and count, and the scaler."""
        return {"params": dict(zip(self._names, self._leaves)),
                "opt_state": self.optimizer.state_dict(),
                "scaler": self.scaler._asdict()}

    def _checkpoint_copies(self, tree: Dict, load_optimizer_states: bool = True):
        """``(own tensor, saved value)`` for every tensor a load writes: the
        params, the optimizer state and the scaler, each name and shape
        checked against this engine before the first copy, so that a tree
        that does not fit raises and changes nothing."""
        params = tree["params"]
        if set(params) != set(self._names):
            raise ValueError(f"checkpoint params {sorted(set(params) ^ set(self._names))[:5]} "
                             "do not match the model's")
        copies = []
        for name, p in zip(self._names, self._leaves):
            src = torch.as_tensor(params[name])
            if src.shape != p.shape:
                raise ValueError(f"checkpoint param {name}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(p.shape)}")
            copies.append((p, src))
        if load_optimizer_states:
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
        """The fp32 master parameters by name, as host copies."""
        return {n: p.detach().to("cpu", copy=True) for n, p in zip(self._names, self._leaves)}

    def save_16bit_model(self, save_dir, save_filename="model.safetensors"):
        """An ``.npz`` of fp16 leaves ``p0``, ``p1``, ... in parameter
        order, as the JAX engine writes it; returns its path."""
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, "model_16bit.npz")
        np.savez(path, **{f"p{i}": t.to(torch.float16).numpy()
                          for i, t in enumerate(self.get_fp32_params().values())})
        return path

    def close(self):
        """Join the async checkpoint finalizer (logging, not raising, its
        failure), drain the checkpoint engine, and drop the captured steps
        with their memory pools.  Idempotent."""
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
        if self.graphs is not None:
            if self._grad_norm is not None:
                self._grad_norm = self._grad_norm.clone()
            self.graphs.clear()
