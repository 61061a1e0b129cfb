"""Asynchronous tensor swapper (counterpart of
``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``).

Requests run on a :class:`~deepspeed_tpu_torch.runtime.offload.StagingPool`:
``swap_out`` enqueues a CRC'd write and returns at once, reads are
verified against the chunk manifest, in-flight depth is capped at the
``aio`` block's ``queue_depth``.  The integer request ids of the
reference's surface map to staging futures.  Tensors are host tensors
(or numpy arrays); a device tensor is refused by the pool.
"""

import os
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.runtime.offload.staging import (StagingFuture, StagingPool,
                                                         as_host_tensor)
from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import get_aio_config


def swap_path(folder: str, key: str) -> str:
    return os.path.join(folder, f"{key}.chunk")


def _dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    return getattr(torch, np.dtype(dtype).name)


class AsyncTensorSwapper:

    def __init__(self, aio_config: Optional[Dict] = None,
                 swap_folder: str = "/tmp/dst_swap", handle=None,
                 buffer_count: int = 2):
        cfg = get_aio_config({"aio": aio_config or {}})
        self.aio_config = cfg
        self.swap_folder = swap_folder
        self.handle = handle            # the reference's surface; I/O goes through the pool
        self.pool = StagingPool(swap_folder, buffer_count=buffer_count,
                                buffer_size=cfg["block_size"], queue_depth=cfg["queue_depth"],
                                thread_count=cfg["thread_count"])
        self._inflight: Dict[int, StagingFuture] = {}
        self._next_rid = 0
        self.swap_count = 0
        self.bytes_swapped = 0

    def _rid(self, fut: StagingFuture) -> int:
        self._next_rid += 1
        self._inflight[self._next_rid] = fut
        return self._next_rid

    def swap_out(self, key: str, array) -> int:
        """Enqueue an async CRC'd write of ``array`` under ``key``; the
        request id."""
        host = as_host_tensor(array)
        self.swap_count += 1
        self.bytes_swapped += host.numel() * host.element_size()
        return self._rid(self.pool.write(key, host))

    def swap_in(self, key: str, shape=None, dtype=None) -> torch.Tensor:
        """Synchronous verified read of a swapped tensor.  Shape and dtype
        come from the manifest; given ones are checked against it."""
        out = self.pool.read_sync(key)
        if shape is not None and tuple(out.shape) != tuple(shape):
            raise ValueError(f"swap_in {key!r}: staged shape {tuple(out.shape)} "
                             f"!= requested {tuple(shape)}")
        if dtype is not None and out.dtype != _dtype(dtype):
            raise ValueError(f"swap_in {key!r}: staged dtype {out.dtype} "
                             f"!= requested {_dtype(dtype)}")
        return out

    def async_swap_in(self, key: str, shape=None, dtype=None):
        """Start an async read: ``(request id, future)``; join with
        ``synchronize(rid)`` and collect with ``fetch(rid)``, or call
        ``future.result()``."""
        fut = self.pool.read(key)
        return self._rid(fut), fut

    def fetch(self, request_id: int) -> torch.Tensor:
        """Join one read request and return its tensor."""
        return self._inflight.pop(request_id).result()

    def synchronize(self, request_id: Optional[int] = None):
        if request_id is not None:
            fut = self._inflight.pop(request_id, None)
            if fut is not None:
                fut.result()
            return
        for fut in list(self._inflight.values()):
            fut.result()
        self._inflight.clear()
        self.pool.sync_manifest()
