"""The train step as one captured CUDA graph (the port's form of the JAX
engine's fused step: ``deepspeed_tpu/runtime/engine.py:2610-2612`` runs one
optimizer step over GAS micro-batches as a single XLA program, its state
donated).

``StepGraphs.run(sources, body)`` runs ``body(static_inputs)``, the whole
step (zero the flat gradients, GAS forward and backward micro-steps, the
unscale, the norm, the clip factor and one fused AdamW launch), as one
replay of a graph captured through the accelerator's ``create_graph`` /
``capture_to_graph`` / ``replay_graph``:

* Captures are kept per batch signature (the shapes and dtypes of the
  ``[gas, micro, ...]`` leaves).  The batch is copied into that capture's
  static device buffers before each replay.
* A signature's first call runs ``body`` eagerly on the capture's side
  stream, and returns its result: this is the warm-up that whole-network
  capture asks for.  It makes everything built on first use: the kernel
  library, cuBLAS workspaces, the block-sparse LUTs and work lists, the
  cross-entropy forward's counters and the occupancy queries.  It is a
  real step, so the trajectory is the eager one.  The blocks it freed go
  back to the device before the capture (``empty_cache``): they sit in
  the side stream's part of the general pool, which neither the graph's
  private pool nor an eager step on the default stream reuses, so kept
  they would double the step's activation memory.  The capture follows;
  it launches nothing.
* The cached device buffers the captured kernels read (lookup tables,
  work lists, counters: ``ops/cuda/capture.py``) are held by the capture,
  so a cache that evicts one cannot free it under the graph, and dropping
  the capture frees what only it held.
* The launch counters (``flash_forward.launches`` and the rest, and the
  plain versions' ``calls``) count Python calls.  A capture calls the
  wrappers and launches nothing; a replay launches everything and calls
  nothing.  So each counter's increase during the capture is taken off
  again, and added back at every replay.
* The generators the step draws from (the engine's, for MoE gating
  noise) are registered with each capture, so every replay draws fresh
  numbers, the ones an eager step at that point would draw.
* A ZeRO step's collectives (NCCL) and host copies (registered host
  memory) are captured as nodes like the kernels: the warm-up has made the
  communicator and run every collective once before the capture.  With a
  process group the capture is ``thread_local``: the NCCL watchdog thread
  may query its events while this thread captures.
* A capture that fails raises with its cause.  Nothing falls back to the
  eager step.
* A caller may run a first call on another thread under a deadline (the
  engine's bounded step, ``comm/bounded.py``).  When that deadline expires
  the caller calls ``abandon()`` and then ``wait_idle()``: an
  abandoned call that is still in its warm-up finishes the step and
  captures nothing; one in its capture ends the capture (the stream leaves
  capture mode) and throws the graph away.  Either way the warm-up's
  outputs are kept as *pending* for the signature: the step ran once, and
  the next call with that signature (the retry, with the same batch)
  captures without a second warm-up and returns them.

The outputs of a replay are the capture's static tensors, which the next
replay overwrites; a caller that keeps one clones it.
"""

import importlib
import threading
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from deepspeed_tpu_torch.ops.cuda import capture

# the modules whose wrappers and plain versions carry launch or call counters
KERNEL_MODULES = ("decode_attention", "flash_attention", "cross_entropy", "fused_optim",
                  "block_sparse_attention")
COUNTER_ATTRS = ("launches", "calls")

Source = Union[torch.Tensor, Sequence[torch.Tensor]]


def launch_counters() -> List[Tuple[object, str]]:
    """``(function, attribute)`` of every launch and call counter the kernel
    modules' attributes hold now (a function patched in under another
    name is found once)."""
    found: Dict[Tuple[int, str], Tuple[object, str]] = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"deepspeed_tpu_torch.ops.cuda.{name}")
        for fn in vars(mod).values():
            for attr in COUNTER_ATTRS:
                if callable(fn) and type(getattr(fn, attr, None)) is int:
                    found[(id(fn), attr)] = (fn, attr)
    return list(found.values())


def read_counters(counters: Sequence[Tuple[object, str]]) -> List[int]:
    return [getattr(fn, attr) for fn, attr in counters]


def add_counters(counters: Sequence[Tuple[object, str]], amounts: Sequence[int]) -> None:
    for (fn, attr), n in zip(counters, amounts):
        if n:
            setattr(fn, attr, getattr(fn, attr) + n)


def signature(sources: Sequence[Source]) -> Tuple:
    """Shapes and dtypes of the ``[gas, ...]`` leaves; a leaf given as a
    list of GAS micro-batch tensors counts as their stack."""
    sig = []
    for src in sources:
        if isinstance(src, torch.Tensor):
            sig.append((tuple(src.shape), src.dtype))
        else:
            sig.append(((len(src),) + tuple(src[0].shape), src[0].dtype))
    return tuple(sig)


def fill(static: torch.Tensor, src: Source) -> None:
    """Copy one leaf (a tensor, or GAS micro-batch tensors) into its static
    buffer on the current stream."""
    if isinstance(src, torch.Tensor):
        static.copy_(src, non_blocking=True)
    else:
        for i, s in enumerate(src):
            static[i].copy_(s, non_blocking=True)


class CapturedStep:
    """One capture: the graph, its static inputs and outputs, what it adds
    to each launch counter per replay, and the cached device buffers its
    kernels read."""

    def __init__(self, graph, inputs, outputs, counters, increase, held=()):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.counters = counters
        self.increase = increase
        self.held = list(held)


class StepAbandoned(RuntimeError):
    """A first call was abandoned (``StepGraphs.abandon``): its graph, if
    any, was thrown away."""


class StepGraphs:
    """The captured steps of one engine, by batch signature.  ``dtype_of``
    maps a source dtype to its static buffer's (the engine's cast of
    floating leaves to the compute dtype); ``generators`` are registered
    with every capture; ``thread_local`` captures in that error mode."""

    def __init__(self, accelerator, device: torch.device,
                 dtype_of: Callable[[torch.dtype], torch.dtype] = lambda dt: dt,
                 generators: Sequence[torch.Generator] = (), thread_local: bool = False):
        self.capture_kwargs = {"capture_error_mode": "thread_local"} if thread_local else {}
        self.accelerator = accelerator
        self.device = device
        self.dtype_of = dtype_of
        self.generators = list(generators)
        self.steps: Dict[Tuple, CapturedStep] = {}
        self.captures = 0
        self.replays = 0
        self._stream = None
        # signature -> (static inputs, warm-up outputs) of a step that ran
        # and was not captured (its first call was abandoned)
        self.pending: Dict[Tuple, Tuple] = {}
        self._abandoned = False
        self._idle = threading.Event()
        self._idle.set()

    def _side_stream(self):
        if self._stream is None:
            self._stream = self.accelerator.Stream(device=self.device)
        return self._stream

    def run(self, sources: Sequence[Source], body: Callable[[List[torch.Tensor]], Tuple],
            key: Tuple = ()):
        """``body``'s outputs for this batch: replayed, or on a new
        signature computed eagerly and then captured.  ``key`` joins the
        signature (a body that captures differently for it)."""
        sig = signature(sources) + tuple(key)
        step = self.steps.get(sig)
        if step is None:
            return self._warm_up_and_capture(sig, sources, body)
        for static, src in zip(step.inputs, sources):
            fill(static, src)
        self.accelerator.replay_graph(step.graph)
        add_counters(step.counters, step.increase)
        self.replays += 1
        return step.outputs

    def abandon(self) -> None:
        """Mark the first call in flight (on another thread) abandoned."""
        self._abandoned = True

    def wait_idle(self, timeout: float = None) -> bool:
        """Wait until no first call is in flight (an abandoned one has
        finished its warm-up or ended its capture); True if none is."""
        idle = self._idle.wait(timeout)
        if idle:
            self._abandoned = False
        return idle

    def _warm_up_and_capture(self, sig, sources, body):
        self._idle.clear()
        try:
            return self._first_call(sig, sources, body)
        finally:
            self._idle.set()

    def _first_call(self, sig, sources, body):
        accel, stream = self.accelerator, self._side_stream()
        current = accel.current_stream(self.device)
        ran = self.pending.get(sig)
        if ran is not None:
            # the step ran in an abandoned call: capture it, no second step
            inputs, outputs = ran
            for static, src in zip(inputs, sources):
                fill(static, src)
            if stream is not None:
                stream.wait_stream(current)
        else:
            inputs = [torch.empty(shape, dtype=self.dtype_of(dt), device=self.device)
                      for shape, dt in signature(sources)]
            for static, src in zip(inputs, sources):
                fill(static, src)
            if stream is not None:
                stream.wait_stream(current)
            with accel.stream(stream):
                outputs = body(inputs)
            if stream is not None:
                current.wait_stream(stream)
                for t in outputs:
                    t.record_stream(current)
            self.pending[sig] = (inputs, outputs)
            if self._abandoned:
                raise StepAbandoned(f"the step for batch signature {sig} was abandoned after "
                                    "its warm-up; not captured")
        accel.empty_cache()

        counters = launch_counters()
        before = read_counters(counters)
        graph = accel.create_graph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        try:
            with capture.holding() as held, accel.capture_to_graph(graph, stream=stream,
                                                                   **self.capture_kwargs):
                static_out = body(inputs)
        except Exception as e:
            raise RuntimeError(f"capturing the train step for batch signature {sig} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            increase = [a - b for a, b in zip(read_counters(counters), before)]
            add_counters(counters, [-n for n in increase])
        if self._abandoned:
            # free the graph, its outputs and its pool here, while nothing
            # captures: left to the collector (the exception's frame holds
            # them) they could be freed during the next capture, which a
            # graph's destruction breaks
            static_out = held = None
            graph.reset()
            graph = None
            accel.empty_cache()
            raise StepAbandoned(f"the capture for batch signature {sig} was abandoned; its "
                                "graph is dropped")
        del self.pending[sig]
        self.steps[sig] = CapturedStep(graph, inputs, static_out, counters, increase,
                                       held.values())
        self.captures += 1
        return outputs

    def clear(self) -> None:
        """Drop every capture (and with the graphs, their memory pools and
        the cached buffers only they held)."""
        self.steps.clear()
        self.pending.clear()
