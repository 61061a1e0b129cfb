"""Collectives over ``torch.distributed`` (counterpart of
``deepspeed_tpu/comm/comm.py``).

The JAX package's collectives are XLA's, inserted by the sharding of the
arrays or called inside ``shard_map`` over a mesh axis; no Pallas kernel
is behind them.  The port runs one process per device and calls NCCL (CUDA
tensors) or gloo (CPU tensors) through ``torch.distributed`` on flat
tensors: ``all_reduce``, ``all_gather``, ``reduce_scatter`` and
``broadcast``, each blocking on the caller's stream (so a captured CUDA
graph holds them as nodes), plus the host-side ``barrier`` and
``broadcast_object_list``.

``init_distributed`` makes the one process group of the process:

* with ``RANK`` and ``WORLD_SIZE`` in the environment, from ``env://``
  (``MASTER_ADDR`` / ``MASTER_PORT``);
* else a world of one on a ``HashStore``, which a ZeRO engine needs for its
  collectives at world size 1 (the process group is made, and the NCCL
  communicator with it, before any collective is captured).

A stage-0 engine at world size 1 makes no group, so the paths that ran
before ZeRO was ported run exactly as they did.

Each tensor collective runs inside ``_log_op`` (JAX ``comm/comm.py:
170-240``): the ``comm.collective`` fault site (``testing/fault_injection.py``,
ctx ``op``), then, when the telemetry plane is wired in
(``configure_metrics_registry`` / ``configure_collective_monitor``, and a
global tracer), the ``comm_bytes_total{op}`` / ``comm_ops_total{op}``
counters, one seq / fingerprint record in the collective monitor's ring and
a ``comm.<op>`` span.  All of it is host code around the launch.  A
collective called eagerly is counted once a call.  One inside a captured
step is counted once, when the graph is captured, and not at its replays:
the JAX package's "staged" semantics, where a collective is counted once,
when it is traced into a program.
"""

import os
import warnings
from contextlib import contextmanager
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.telemetry.tracing import get_global_tracer
from deepspeed_tpu_torch.testing.fault_injection import fault_point

ReduceOp = dist.ReduceOp
DEFAULT_TIMEOUT = timedelta(minutes=10)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def env_world_size() -> int:
    """The world size a process group has or would have: the group's, else
    ``WORLD_SIZE`` from the environment, else 1."""
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(dist_backend: Optional[str] = None, device=None,
                     timeout: Optional[timedelta] = None,
                     init_method: Optional[str] = None, rank: int = -1,
                     world_size: int = -1) -> None:
    """Make the process group once (a second call returns): NCCL for a CUDA
    ``device``, gloo for the CPU, unless ``dist_backend`` names one.  With
    no ``device`` the rank's own GPU: ``cuda:LOCAL_RANK`` under the
    launcher (``accelerator/real_accelerator.py:resolve_device``)."""
    if is_initialized():
        return
    if device is None:
        from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
        dev = resolve_device(None)
    else:
        dev = torch.device(device)
    backend = dist_backend or backend_for(dev)
    timeout = timeout or DEFAULT_TIMEOUT
    # torch 2.13 renamed the tensor collectives (``all_gather_single``, ...);
    # the card's torch 2.11 has only the old names, which both keep
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=r".*is deprecated\. Please use `torch\.distributed\.")
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is not None or env or world_size > 1:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=timeout, rank=rank, world_size=world_size, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout, **kw)


def destroy_process_group() -> None:
    if is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def barrier() -> None:
    if is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def broadcast_object_list(objs: List, src: int = 0) -> List:
    """``objs`` as rank ``src`` holds them, on every rank (in place)."""
    if is_initialized() and dist.get_world_size() > 1:
        dist.broadcast_object_list(objs, src=src)
    return objs


# --------------------------------------------------------------------------- #
# Telemetry hooks: the registry's per-op counters, the collective monitor
# --------------------------------------------------------------------------- #
_METRICS_REGISTRY = None
_COLLECTIVE_MONITOR = None
# a collective's group as the monitor's and the span's ``axis``: the port
# has one process group, the world
_AXIS = "world"


def configure_metrics_registry(registry):
    """Attach the live MetricsRegistry (None detaches it): every tensor
    collective then increments ``comm_bytes_total{op=...}`` /
    ``comm_ops_total{op=...}`` — once a call eagerly, once at the capture
    inside a captured step (module docstring)."""
    global _METRICS_REGISTRY
    _METRICS_REGISTRY = registry


def configure_collective_monitor(monitor):
    """Attach the per-rank CollectiveMonitor (None detaches it): every
    tensor collective then gets a monotonic seq_no + structure fingerprint
    in the monitor's bounded ring, with enter / exit stamps on the host
    around its launch."""
    global _COLLECTIVE_MONITOR
    _COLLECTIVE_MONITOR = monitor


@contextmanager
def _log_op(name: str, tensor: torch.Tensor):
    """Per-collective instrumentation around one launch: the
    ``comm.collective`` fault site, the registry's byte / op counters, a
    seq / fingerprint record in the collective monitor's ring and a
    ``comm.<op>`` span tagged {op, axis, bytes, seq} on the global tracer —
    the span's ``seq`` joins trace timelines to collective records by
    (rank, seq).  Reads only the tensor's metadata, never its value."""
    fault_point("comm.collective", op=name)
    nbytes = tensor.numel() * tensor.element_size()
    if _METRICS_REGISTRY is not None:
        _METRICS_REGISTRY.counter("comm_bytes_total", {"op": name}).inc(nbytes)
        _METRICS_REGISTRY.counter("comm_ops_total", {"op": name}).inc()
    axis = _AXIS
    mon = _COLLECTIVE_MONITOR
    rec = None
    if mon is not None:
        try:
            rec = mon.begin(name, axis, str(tensor.dtype).replace("torch.", ""),
                            tuple(tensor.shape), nbytes)
        except Exception:
            rec = None
    try:
        tracer = get_global_tracer()
        if tracer is None:
            yield
            return
        span_args = {"op": name, "axis": axis, "bytes": nbytes}
        if rec is not None:
            span_args["seq"] = rec["seq"]
        with tracer.span(f"comm.{name}", **span_args):
            yield
    finally:
        if rec is not None:
            mon.end(rec)


# --------------------------------------------------------------------------- #
# Collectives on flat tensors
# --------------------------------------------------------------------------- #
def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM) -> torch.Tensor:
    """``tensor`` summed (or ``op``) over the ranks, in place."""
    with _log_op("all_reduce", tensor):
        dist.all_reduce(tensor, op=op)
    return tensor


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def all_gather(output: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` laid end to end into ``output`` (``world *
    tensor.numel()`` elements), in rank order.  ``tensor`` may be this
    rank's slice of ``output`` (in place): NCCL takes that as it is, gloo
    gets a copy."""
    with _log_op("all_gather", tensor):
        if get_backend() == "gloo" and _shares_storage(output, tensor):
            tensor = tensor.clone()
        dist.all_gather_into_tensor(output, tensor)
    return output


def reduce_scatter(output: torch.Tensor, tensor: torch.Tensor,
                   op=ReduceOp.SUM) -> torch.Tensor:
    """Rank r's ``output`` is slice r of ``tensor`` summed over the ranks."""
    with _log_op("reduce_scatter", tensor):
        dist.reduce_scatter_tensor(output, tensor, op=op)
    return output


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    with _log_op("broadcast", tensor):
        dist.broadcast(tensor, src=src)
    return tensor
