"""Pluggable checkpoint storage backends (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``).

The engine-level logic (``runtime/checkpointing.py``) calls only this
interface:

- ``create(tag)``   — begin a checkpoint under ``tag`` (bookkeeping only);
- ``save(state, path)`` — persist one state tree (a nested dict of
  tensors); an async engine returns once the tensors are on the host;
- ``load(path)``    — the saved tree, as CPU tensors (the caller copies
  them into its own storage);
- ``commit(tag)``   — barrier: everything saved under ``tag`` is durable
  once this returns;
- ``exists(path)``  — a checkpoint previously saved at ``path`` is there;
- ``wait()``        — drain every in-flight save.

Backends, by the ``checkpoint.engine`` config key:

* ``"torch"`` (also ``"default"`` and ``"orbax"``, the JAX package's
  default name: the card's machine has no Orbax): :class:`TorchCheckpointEngine`,
  one ``torch.save`` file ``<path>.pt``, the reference DeepSpeed's own
  store.  With ``async_save`` the file is written by a background thread.
* ``"local"``: :class:`LocalCheckpointEngine`, one ``<path>.npz`` of named
  arrays (bf16 stored as fp32, which holds every bf16 value exactly).
* ``"faulty"``: a test backend, the engine named by ``config_params["inner"]``
  (default ``"local"``) wrapped in ``testing/fault_injection.py``'s
  :class:`FaultyCheckpointEngine`, with fault sites around every storage
  call; ``config_params["plan"]`` gives it a plan of its own, else the
  installed one drives it.

Every save first copies each tensor to host memory on the calling thread
(device-to-host copies into pageable buffers, then one stream sync), so
no other thread ever touches the device: a CUDA graph capture in the
training thread stays valid while a file is written.
"""

import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist

SEP = "/"


def flatten_state(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": t}}`` -> ``{"a/b": t}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_state(v, f"{prefix}{k}{SEP}"))
        else:
            out[prefix + k] = v
    return out


def unflatten_state(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def host_snapshot(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Every tensor of ``tree`` copied to host memory, on this thread.

    Pageable on purpose: freeing a pinned buffer records CUDA events in the
    thread that frees it, and the writer thread must make no CUDA call."""
    flat = flatten_state(tree)
    out, streams = {}, set()
    for key, t in flat.items():
        t = torch.as_tensor(t).detach()
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu")
        host.copy_(t, non_blocking=t.is_cuda)
        if t.is_cuda:
            streams.add(t.device)
        out[key] = host
    for device in streams:
        torch.cuda.current_stream(device).synchronize()
    return unflatten_state(out)


class CheckpointEngine:

    def makedirs(self, path: str, exist_ok: bool = True):
        os.makedirs(path, exist_ok=exist_ok)

    def create(self, tag: str):
        log_dist(f"[{type(self).__name__}] checkpoint {tag} is about to be saved!", ranks=[0])

    def save(self, state: Dict[str, Any], path: str):
        raise NotImplementedError

    def load(self, path: str) -> Dict[str, Any]:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        return True

    def exists(self, path: str) -> bool:
        return os.path.isdir(path)

    def wait(self):
        """Drain in-flight async saves (nothing for synchronous engines)."""


class TorchCheckpointEngine(CheckpointEngine):
    """One ``torch.save`` file per state tree.  ``async_save=True`` returns
    from ``save`` once the tensors are on the host; a background thread
    writes the file, and ``commit`` / ``wait`` join it (the role of the
    JAX package's Orbax ``AsyncCheckpointer``)."""

    SUFFIX = ".pt"

    def __init__(self, async_save: bool = False):
        self.async_save = async_save
        self._writers: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    def _write(self, state: Dict[str, Any], path: str):
        self.makedirs(os.path.dirname(path) or ".")
        tmp = path + self.SUFFIX + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path + self.SUFFIX)

    def save(self, state: Dict[str, Any], path: str):
        host = host_snapshot(state)
        self._errors = []
        if not self.async_save:
            self._write(host, path)
            return

        def write():
            try:
                self._write(host, path)
            except BaseException as e:       # raised at commit / wait
                self._errors.append(e)
        t = threading.Thread(target=write, daemon=True, name=f"ckpt-write-{os.path.basename(path)}")
        t.start()
        self._writers.append(t)

    def load(self, path: str) -> Dict[str, Any]:
        return torch.load(path + self.SUFFIX, map_location="cpu", weights_only=True)

    def exists(self, path: str) -> bool:
        return os.path.isfile(path + self.SUFFIX)

    def commit(self, tag: str) -> bool:
        self.wait()
        log_dist(f"[Torch] checkpoint {tag} is ready now!", ranks=[0])
        return True

    def wait(self):
        """Join the writers; a failed write raises here, and again at every
        wait until the next save (its bytes are not on disk)."""
        while self._writers:
            self._writers.pop(0).join()
        if self._errors:
            raise self._errors[0]


class LocalCheckpointEngine(CheckpointEngine):
    """Dependency-free host store: one ``.npz`` of named arrays (the JAX
    package's ``LocalCheckpointEngine`` format, keyed by path instead of
    leaf index).  bf16 tensors are stored as fp32, exactly."""

    SUFFIX = ".npz"

    def save(self, state: Dict[str, Any], path: str):
        flat = flatten_state(host_snapshot(state))
        self.makedirs(os.path.dirname(path) or ".")
        arrays = {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                  for k, t in flat.items()}
        with open(path + self.SUFFIX, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())

    def load(self, path: str) -> Dict[str, Any]:
        with np.load(path + self.SUFFIX) as data:
            return unflatten_state({k: torch.from_numpy(data[k]) for k in data.files})

    def exists(self, path: str) -> bool:
        return os.path.isfile(path + self.SUFFIX)


def get_checkpoint_engine(name: str = "orbax", async_save: bool = False,
                          config_params: Optional[Dict] = None) -> CheckpointEngine:
    if name in ("torch", "default", "orbax"):
        return TorchCheckpointEngine(async_save=async_save)
    if name == "local":
        return LocalCheckpointEngine()
    if name == "faulty":
        from deepspeed_tpu_torch.testing.fault_injection import (FaultInjector,
                                                                 FaultyCheckpointEngine)
        cp = dict(config_params or {})
        inner = get_checkpoint_engine(cp.get("inner", "local"), async_save=async_save)
        plan = cp.get("plan")
        return FaultyCheckpointEngine(
            inner, injector=FaultInjector(plan) if plan is not None else None)
    raise ValueError(f"unknown checkpoint engine {name!r}")
